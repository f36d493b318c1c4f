"""Decoder-only language model, dense family (port of ``repro/models/lm.py``).

Layers are stacked along a leading ``[L, ...]`` axis as in the reference;
where the reference scans over that axis, the port loops in Python. The
training forward takes the layers apart with one ``torch.unbind`` per leaf
(its backward stacks the L layer gradients once, where indexing each layer
would write a full-size gradient of the stack per layer), and with
``cfg.remat`` runs each block under ``torch.utils.checkpoint`` (the
reference's ``jax.checkpoint`` around the scan body).
"""
from __future__ import annotations

import math
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models.common import ModelConfig, dense_init, embed_init, rms_norm
from repro_torch.models.mlp import init_mlp, mlp

Tree = Any


def _layer(tree: Tree, i: int) -> Tree:
    """Layer ``i`` of a stacked [L, ...] tree (views, no copies)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _unstack(tree: Tree, n: int) -> list[Tree]:
    """The n layers of a stacked [L, ...] tree, one ``unbind`` per leaf."""
    if isinstance(tree, dict):
        per_key = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(torch.unbind(tree, 0))


def init_lm(gen: torch.Generator, cfg: ModelConfig, device) -> Tree:
    if cfg.n_experts:
        raise NotImplementedError("MoE layers come with a later slice of the port (ROADMAP.md)")
    L = cfg.n_layers
    pd = cfg.pdtype
    layers = {
        "attn": attn.init_attention(gen, cfg, device, n_layers=L),
        "ln1_scale": torch.zeros((L, cfg.d_model), dtype=pd, device=device),
        "ln2_scale": torch.zeros((L, cfg.d_model), dtype=pd, device=device),
    }
    if cfg.post_norm:
        layers["ln1_post_scale"] = torch.zeros((L, cfg.d_model), dtype=pd, device=device)
        layers["ln2_post_scale"] = torch.zeros((L, cfg.d_model), dtype=pd, device=device)
    layers["mlp"] = init_mlp(gen, cfg, device, n_layers=L)
    params = {
        "embed": embed_init(gen, (cfg.vocab, cfg.d_model), dtype=pd, device=device),
        "layers": layers,
        "final_norm_scale": torch.zeros((cfg.d_model,), dtype=pd, device=device),
    }
    if not cfg.tie_embeddings:
        params["head"] = dense_init(gen, (cfg.d_model, cfg.vocab), fan_in=cfg.d_model,
                                    dtype=pd, device=device)
    return params


def _ffn(cfg: ModelConfig, x: torch.Tensor, h: torch.Tensor, lp: Tree) -> torch.Tensor:
    """Residual add of the attention output, then the MLP sublayer."""
    if cfg.post_norm:
        h = rms_norm(h, lp["ln1_post_scale"])
    x = x + h
    h = mlp(lp["mlp"], cfg, rms_norm(x, lp["ln2_scale"]))
    if cfg.post_norm:
        h = rms_norm(h, lp["ln2_post_scale"])
    return x + h


def _block(cfg: ModelConfig, x: torch.Tensor, lp: Tree, positions: torch.Tensor,
           return_kv: bool = False):
    """One transformer block. Returns x (and the block's post-RoPE (k, v)
    when ``return_kv``, for cache-filling prefill)."""
    h = attn.attend(lp["attn"], cfg, rms_norm(x, lp["ln1_scale"]), positions,
                    return_kv=return_kv)
    if return_kv:
        h, kv = h
        return _ffn(cfg, x, h, lp), kv
    return _ffn(cfg, x, h, lp)


def _embed(cfg: ModelConfig, params: Tree, tokens: torch.Tensor) -> torch.Tensor:
    # gather then cast: elementwise the same as the reference's cast-then-gather,
    # without casting the whole table per call
    dt = cfg.compute_dtype
    x = params["embed"][tokens.long()].to(dt)
    scale = torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32).to(dt).item()
    return x * scale


def _logits(cfg: ModelConfig, params: Tree, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm_scale"])
    w = params["head"] if "head" in params else params["embed"].T
    logits = x @ w.to(cfg.compute_dtype)
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    return logits


def forward_lm(cfg: ModelConfig, params: Tree, tokens: torch.Tensor, last_only: bool = False,
               hidden_only: bool = False, **_) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward. tokens [B, S] -> (logits [B,S,V], aux = 0 for the dense family)."""
    x = _embed(cfg, params, tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in _unstack(params["layers"], cfg.n_layers):
        if remat:
            x = checkpoint(lambda x, lp=lp: _block(cfg, x, lp, positions), x,
                           use_reentrant=False)
        else:
            x = _block(cfg, x, lp, positions)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if last_only:
        x = x[:, -1:]
    if hidden_only:
        return rms_norm(x, params["final_norm_scale"]), aux
    return _logits(cfg, params, x), aux


def prefill_lm(cfg: ModelConfig, params: Tree, tokens: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched prefill: one forward pass over the whole prompt that also
    emits every layer's post-RoPE K/V.

    tokens [B, P] -> (logits [B, P, V], k [L, B, P, KV, hd], v [...]).
    """
    x = _embed(cfg, params, tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, (k, v) = _block(cfg, x, _layer(params["layers"], i), positions, return_kv=True)
        ks.append(k)
        vs.append(v)
    return _logits(cfg, params, x), torch.stack(ks), torch.stack(vs)


def paged_decode_step_lm(cfg: ModelConfig, params: Tree, cache: Tree, token: torch.Tensor,
                         page_table: torch.Tensor, lengths: torch.Tensor,
                         impl: str = "xla") -> tuple[torch.Tensor, Tree]:
    """One decode step against the paged KV pool (continuous batching).

    token [B] int32; cache from ``attention.init_paged_cache`` (written in
    place); page_table [B, max_pages] int32; lengths [B] int32 (per-slot
    position of the new token). Returns (logits [B, V], cache).
    """
    x = _embed(cfg, params, token[:, None])
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        h, _ = attn.paged_attend_decode(lp["attn"], cfg, rms_norm(x, lp["ln1_scale"]),
                                        _layer(cache, i), page_table, lengths, impl=impl)
        x = _ffn(cfg, x, h, lp)
    return _logits(cfg, params, x)[:, 0], cache


def paged_prefill_lm(cfg: ModelConfig, params: Tree, cache: Tree, tokens: torch.Tensor,
                     page_table: torch.Tensor, lengths: torch.Tensor
                     ) -> tuple[torch.Tensor, Tree]:
    """Batched prefill into the paged pool.

    tokens [B, P] (right-padded to the admitted group's longest prompt;
    ``lengths`` holds each row's true prompt length) -> (logits [B, P, V],
    cache with every valid prompt position written to its page, in place).
    """
    logits, k, v = prefill_lm(cfg, params, tokens)
    for i in range(cfg.n_layers):
        attn.fill_paged_cache(_layer(cache, i), k[i], v[i], page_table, lengths)
    return logits, cache
