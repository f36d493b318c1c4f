"""Llama-3.2-Vision language backbone (port of ``repro/models/vlm.py``,
hf:meta-llama/Llama-3.2-11B-Vision).

A causal LM where every ``vlm_period``-th layer is a *gated cross-attention*
block attending to image patch embeddings. The ViT and projector are a
stub: the context is [B, n_image_tokens, d_model] and ``image_proj`` stands
in for the projector. n_layers at period p make n_layers / p superblocks of
(1 cross + p - 1 self) layers; the self layers are stacked
``[n_super, p - 1, ...]``, the cross layers ``[n_super, ...]`` with their
tanh gates ``attn/gate`` and ``mlp_gate`` (zero: the cross path starts
closed).

Where the reference scans, the port loops in Python; with ``cfg.remat``
each superblock runs under ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint`` of the superblock). Decode caches are written in place:
``fill_context_vlm`` projects the patches once a request and writes every
superblock's cross K/V into the cache.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models import attention as attn
from repro_torch.models.common import ModelConfig, dense_init, embed_init, remat, rms_norm
from repro_torch.models.lm import _embed, _group, _layer, _unstack
from repro_torch.models.mlp import init_mlp, mlp

Tree = Any


def _blocks(cfg: ModelConfig) -> tuple[int, int]:
    """(superblocks, self layers a superblock)."""
    assert cfg.n_layers % cfg.vlm_period == 0, "n_layers must divide into superblocks"
    return cfg.n_layers // cfg.vlm_period, cfg.vlm_period - 1


def init_vlm(gen: torch.Generator, cfg: ModelConfig, device) -> Tree:
    ns, per = _blocks(cfg)
    pd = cfg.pdtype
    d, n_self = cfg.d_model, ns * per

    def zeros(*shape):
        return torch.zeros(shape, dtype=pd, device=device)

    self_layers = _group({
        "attn": attn.init_attention(gen, cfg, device, n_layers=n_self),
        "mlp": init_mlp(gen, cfg, device, n_layers=n_self),
        "ln1_scale": zeros(n_self, d),
        "ln2_scale": zeros(n_self, d),
    }, ns, per)
    cross_layers = {
        "attn": attn.init_attention(gen, cfg, device, n_layers=ns, cross=True),
        "mlp": init_mlp(gen, cfg, device, n_layers=ns),
        "ln1_scale": zeros(ns, d),
        "ln2_scale": zeros(ns, d),
        "mlp_gate": zeros(ns),
    }
    return {
        "embed": embed_init(gen, (cfg.vocab, d), dtype=pd, device=device),
        "image_proj": dense_init(gen, (d, d), dtype=pd, device=device),  # projector stub
        "self_layers": self_layers,
        "cross_layers": cross_layers,
        "final_norm_scale": zeros(d),
        "head": dense_init(gen, (d, cfg.vocab), fan_in=d, dtype=pd, device=device),
    }


def _image(cfg: ModelConfig, params: Tree, context: torch.Tensor) -> torch.Tensor:
    dt = cfg.compute_dtype
    return context.to(dt) @ params["image_proj"].to(dt)


def _cross_block(cfg: ModelConfig, cp: Tree, x: torch.Tensor, img) -> torch.Tensor:
    """The gated cross layer; ``img`` the projected patches [B, N, d] or
    their cached ``(k, v)``."""
    x = x + attn.cross_attend(cp["attn"], cfg, rms_norm(x, cp["ln1_scale"]), img, gated=True)
    g = torch.tanh(cp["mlp_gate"].float()).to(x.dtype)
    return x + g * mlp(cp["mlp"], cfg, rms_norm(x, cp["ln2_scale"]))


def _self_block(cfg: ModelConfig, lp: Tree, x: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    x = x + attn.attend(lp["attn"], cfg, rms_norm(x, lp["ln1_scale"]), positions)
    return x + mlp(lp["mlp"], cfg, rms_norm(x, lp["ln2_scale"]))


def forward_vlm(cfg: ModelConfig, params: Tree, tokens: torch.Tensor,
                context: torch.Tensor | None = None, last_only: bool = False,
                hidden_only: bool = False, **_) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S], context = image patch embeddings [B, N, d] -> (logits
    [B, S, V] (the final-normed hidden states with ``hidden_only``), aux 0)."""
    assert context is not None, "vlm forward requires image context"
    ns, per = _blocks(cfg)
    img = _image(cfg, params, context)
    x = _embed(cfg, params, tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)

    def superblock(x, img, cp, group):
        x = _cross_block(cfg, cp, x, img)
        for lp in _unstack(group, per):
            x = _self_block(cfg, lp, x, positions)
        return x

    for cp, group in zip(_unstack(params["cross_layers"], ns),
                         _unstack(params["self_layers"], ns)):
        if cfg.remat:
            x = remat(lambda x, img, cp=cp, group=group: superblock(x, img, cp, group), x, img)
        else:
            x = superblock(x, img, cp, group)
    if last_only:
        x = x[:, -1:]
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    x = rms_norm(x, params["final_norm_scale"])
    if hidden_only:
        return x, zero
    return x @ params["head"].to(cfg.compute_dtype), zero


def init_cache_vlm(cfg: ModelConfig, params: Tree, batch: int, cache_len: int) -> Tree:
    """{"self": the self layers' dense KV cache [ns, per, B, cache_len, KV,
    hd] (the ring of min(cache_len, window) slots with a sliding window),
    "cross_k", "cross_v": [ns, B, n_image_tokens, KV, hd] zeros, filled by
    :func:`fill_context_vlm`}."""
    ns, per = _blocks(cfg)
    device = params["embed"].device
    if cfg.sliding_window:
        cache_len = min(cache_len, cfg.sliding_window)
    shape = (ns, batch, cfg.n_image_tokens, cfg.n_kv_heads, cfg.hd)
    return {
        "self": _group(attn.init_cache(cfg, batch, cache_len, ns * per, device), ns, per),
        "cross_k": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
        "cross_v": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
    }


def fill_context_vlm(cfg: ModelConfig, params: Tree, cache: Tree,
                     context: torch.Tensor) -> Tree:
    """Condition a decode cache on the image context, in place: project the
    patch embeddings and write every superblock's cross-attention K/V (the
    VLM's twin of ``fill_context_whisper``)."""
    img = _image(cfg, params, context)
    ca = params["cross_layers"]["attn"]
    for i in range(_blocks(cfg)[0]):
        k, v = attn.cross_kv(_layer(ca, i), cfg, img)
        cache["cross_k"][i].copy_(k)
        cache["cross_v"][i].copy_(v)
    return cache


def decode_step_vlm(cfg: ModelConfig, params: Tree, cache: Tree, token: torch.Tensor,
                    pos: int, **_) -> tuple[torch.Tensor, Tree]:
    """One decode step against :func:`init_cache_vlm`'s cache after
    :func:`fill_context_vlm` (the self cache written in place). Returns
    (logits [B, V], cache)."""
    ns, per = _blocks(cfg)
    x = _embed(cfg, params, token[:, None])
    for i in range(ns):
        cp = _layer(params["cross_layers"], i)
        x = _cross_block(cfg, cp, x, (cache["cross_k"][i], cache["cross_v"][i]))
        group, caches = _layer(params["self_layers"], i), _layer(cache["self"], i)
        for j in range(per):
            lp = _layer(group, j)
            h, _ = attn.attend_decode(lp["attn"], cfg, rms_norm(x, lp["ln1_scale"]),
                                      _layer(caches, j), pos)
            x = x + h
            x = x + mlp(lp["mlp"], cfg, rms_norm(x, lp["ln2_scale"]))
    x = rms_norm(x, params["final_norm_scale"])
    return (x @ params["head"].to(cfg.compute_dtype))[:, 0], cache
