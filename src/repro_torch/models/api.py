"""Model API (port of ``repro/models/api.py``), dense family only.

    model = build_model(cfg)
    params = model.init(gen, device)
    logits, aux = model.forward(params, tokens)
    loss, metrics = model.loss(params, batch)
    cache = model.init_paged_cache(n_pages, page_size, device)
    logits, cache = model.paged_prefill(params, cache, tokens, page_table, lengths)
    logits, cache = model.paged_decode_step(params, cache, token, page_table, lengths)

The other families (moe, ssm, hybrid, audio, vlm) come with later slices of
the port (ROADMAP.md).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.models import attention, lm
from repro_torch.models.common import ModelConfig, fused_cross_entropy, softmax_cross_entropy

Tree = Any

_FAMILIES: dict[str, dict[str, Callable]] = {
    "dense": {
        "init": lm.init_lm, "forward": lm.forward_lm,
        "paged_prefill": lm.paged_prefill_lm, "paged_decode": lm.paged_decode_step_lm,
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

    def forward(self, params: Tree, tokens: torch.Tensor, last_only: bool = False):
        return self._fam["forward"](self.cfg, params, tokens, last_only=last_only)

    # --- training ---
    def head_weight(self, params: Tree) -> torch.Tensor:
        if self.cfg.tie_embeddings and "head" not in params:
            return params["embed"].T
        return params["head"]

    def loss(self, params: Tree, batch: dict, fused: bool = True) -> tuple[torch.Tensor, dict]:
        """Training loss of ``batch`` ({"tokens", "labels"} int [B, S]).
        ``fused`` uses the chunked head + cross-entropy (never materialises
        the [B, S, V] logits); disabled automatically for softcap."""
        if fused and not self.cfg.logit_softcap:
            hidden, _ = self._fam["forward"](self.cfg, params, batch["tokens"],
                                             hidden_only=True)
            loss, metrics = fused_cross_entropy(hidden, self.head_weight(params),
                                                batch["labels"])
        else:
            logits, _ = self.forward(params, batch["tokens"])
            loss, metrics = softmax_cross_entropy(logits, batch["labels"])
        metrics["loss_total"] = loss
        return loss, metrics

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
        raise ValueError(f"arch_type {cfg.arch_type!r} is not ported to repro_torch yet "
                         "(only 'dense'); see ROADMAP.md for the order of slices")
    if cfg.n_experts:
        raise ValueError("MoE layers are not ported to repro_torch yet; see ROADMAP.md")
    return Model(cfg)
