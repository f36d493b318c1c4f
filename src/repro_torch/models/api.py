"""Model API (port of ``repro/models/api.py``): the dense, MoE, SSM,
hybrid, audio and VLM families, all six of the reference's.

    model = build_model(cfg)
    params = model.init(gen, device)
    logits, aux = model.forward(params, tokens, context=None)
    loss, metrics = model.loss(params, batch)
    cache = model.init_cache(params, batch_size, cache_len)
    logits, cache = model.decode_step(params, cache, token, pos)
    logits, cache = model.prefill_with_cache(params, cache, tokens)
    logits_last = model.prefill(params, tokens)
    cache = model.init_paged_cache(n_pages, page_size, device)
    logits, cache = model.paged_prefill(params, cache, tokens, page_table, lengths)
    logits, cache = model.paged_decode_step(params, cache, token, page_table, lengths)

Caches are written in place (the reference returns new ones). The MoE
loss adds ``router_aux_coef`` times the layers' summed load-balance aux and
reports it as ``metrics["moe_aux"]``. The SSM, hybrid, audio and VLM
families have neither a batched prefill nor a paged decode path: they serve
through the naive engine, which prefills by stepping the decode path. The
audio (whisper) and VLM (llama-3.2-vision) families take a context, audio
frames or image patches [B, N, d_model]: the forward and ``loss`` (from
``batch["context"]``) require it, and ``fill_context`` writes it into a
decode cache as cross-attention K/V.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.models import attention, lm, ssm_lm, vlm, whisper
from repro_torch.models.common import ModelConfig, fused_cross_entropy, softmax_cross_entropy

Tree = Any

_LM_FAMILY: dict[str, Callable] = {
    "init": lm.init_lm, "forward": lm.forward_lm,
    "init_cache": lm.init_cache_lm, "decode_step": lm.decode_step_lm,
    "prefill_cache": lm.prefill_with_cache_lm,
    "paged_prefill": lm.paged_prefill_lm, "paged_decode": lm.paged_decode_step_lm,
}
_FAMILIES: dict[str, dict[str, Callable]] = {
    "dense": _LM_FAMILY, "moe": _LM_FAMILY,
    "ssm": {
        "init": ssm_lm.init_ssm_lm, "forward": ssm_lm.forward_ssm_lm,
        "init_cache": ssm_lm.init_cache_ssm_lm, "decode_step": ssm_lm.decode_step_ssm_lm,
    },
    "hybrid": {
        "init": ssm_lm.init_hybrid_lm, "forward": ssm_lm.forward_hybrid_lm,
        "init_cache": ssm_lm.init_cache_hybrid_lm, "decode_step": ssm_lm.decode_step_hybrid_lm,
    },
    "audio": {
        "init": whisper.init_whisper, "forward": whisper.forward_whisper,
        "init_cache": whisper.init_cache_whisper, "decode_step": whisper.decode_step_whisper,
        "fill_context": whisper.fill_context_whisper,
    },
    "vlm": {
        "init": vlm.init_vlm, "forward": vlm.forward_vlm,
        "init_cache": vlm.init_cache_vlm, "decode_step": vlm.decode_step_vlm,
        "fill_context": vlm.fill_context_vlm,
    },
}


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    @property
    def _fam(self):
        return _FAMILIES[self.cfg.arch_type]

    def init(self, gen: torch.Generator, device) -> Tree:
        return self._fam["init"](gen, self.cfg, device)

    def forward(self, params: Tree, tokens: torch.Tensor, context: torch.Tensor | None = None,
                last_only: bool = False):
        return self._fam["forward"](self.cfg, params, tokens, context=context,
                                    last_only=last_only)

    # --- training ---
    def head_weight(self, params: Tree) -> torch.Tensor:
        if self.cfg.tie_embeddings and "head" not in params:
            return params["embed"].T
        return params["head"]

    def loss(self, params: Tree, batch: dict, fused: bool = True) -> tuple[torch.Tensor, dict]:
        """Training loss of ``batch`` ({"tokens", "labels"} int [B, S], and
        for the audio and VLM families "context" [B, N, d_model]). ``fused``
        uses the chunked head + cross-entropy (never materialises the [B, S,
        V] logits); disabled automatically for softcap."""
        context = batch.get("context")
        if fused and not self.cfg.logit_softcap:
            hidden, aux = self._fam["forward"](self.cfg, params, batch["tokens"],
                                               context=context, hidden_only=True)
            loss, metrics = fused_cross_entropy(hidden, self.head_weight(params),
                                                batch["labels"])
        else:
            logits, aux = self.forward(params, batch["tokens"], context=context)
            loss, metrics = softmax_cross_entropy(logits, batch["labels"])
        if self.cfg.n_experts and self.cfg.router_aux_coef:
            loss = loss + self.cfg.router_aux_coef * aux
            metrics["moe_aux"] = aux
        metrics["loss_total"] = loss
        return loss, metrics

    # --- serving ---
    def init_cache(self, params: Tree, batch: int, cache_len: int) -> Tree:
        return self._fam["init_cache"](self.cfg, params, batch, cache_len)

    def decode_step(self, params: Tree, cache: Tree, token: torch.Tensor, pos: int):
        return self._fam["decode_step"](self.cfg, params, cache, token, pos)

    def fill_context(self, params: Tree, cache: Tree, context: torch.Tensor) -> Tree:
        """Condition a decode cache on the request context (audio frames /
        image patches). Families without cross-attention return the cache
        unchanged, so serving paths can call this unconditionally."""
        fn = self._fam.get("fill_context")
        return fn(self.cfg, params, cache, context) if fn is not None else cache

    @property
    def attention_layers(self) -> int:
        """Self-attention layers a forward runs through the flash kernel:
        every layer of the dense and MoE families, none of the SSM family,
        the shared block once a superblock of the hybrid, the encoder's and
        the decoder's of whisper, and the self layers of the VLM (its cross
        layers are plain torch)."""
        kind, cfg = self.cfg.arch_type, self.cfg
        if kind == "ssm":
            return 0
        if kind == "hybrid":
            return ssm_lm._n_super(cfg)
        if kind == "audio":
            return whisper._n_encoder(cfg) + cfg.n_layers
        if kind == "vlm":
            ns, per = vlm._blocks(cfg)
            return ns * per
        return cfg.n_layers

    @property
    def supports_batched_prefill(self) -> bool:
        """True when the family fills a dense cache at every prompt position
        in one forward dispatch (attention-cache families)."""
        return "prefill_cache" in self._fam

    def prefill_with_cache(self, params: Tree, cache: Tree, tokens: torch.Tensor):
        """Batched prefill: (per-position logits [B, P, V], filled cache)."""
        return self._fam["prefill_cache"](self.cfg, params, cache, tokens)

    def prefill(self, params: Tree, tokens: torch.Tensor, context: torch.Tensor | None = None):
        """Full-sequence forward returning the last position's logits [B, V]
        (the [B, S, V] logits are never materialised)."""
        logits, _ = self._fam["forward"](self.cfg, params, tokens, context=context,
                                         last_only=True)
        return logits[:, -1]

    # --- paged serving (repro_torch.serving) ---
    @property
    def supports_paged_decode(self) -> bool:
        return "paged_decode" in self._fam

    def init_paged_cache(self, n_pages: int, page_size: int, device) -> Tree:
        return attention.init_paged_cache(self.cfg, n_pages, page_size, self.cfg.n_layers,
                                          device)

    def paged_prefill(self, params: Tree, cache: Tree, tokens: torch.Tensor,
                      page_table: torch.Tensor, lengths: torch.Tensor):
        return self._fam["paged_prefill"](self.cfg, params, cache, tokens, page_table, lengths)

    def paged_decode_step(self, params: Tree, cache: Tree, token: torch.Tensor,
                          page_table: torch.Tensor, lengths: torch.Tensor, impl: str = "xla"):
        return self._fam["paged_decode"](self.cfg, params, cache, token, page_table, lengths,
                                         impl=impl)


def build_model(cfg: ModelConfig) -> Model:
    if cfg.arch_type not in _FAMILIES:
        raise ValueError(f"unknown arch_type {cfg.arch_type!r} (families: {sorted(_FAMILIES)})")
    return Model(cfg)
