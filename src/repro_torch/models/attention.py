"""Grouped-query attention with RoPE, QK-norm, sliding window and a paged KV
cache (port of the serving parts of ``repro/models/attention.py``).

Entry points of this slice:
  * ``attend``              — full-sequence (prefill)
  * ``paged_attend_decode`` — one new token per slot against the paged pool
  * ``fill_paged_cache``    — scatter a batched prefill's K/V into pages

The paged pool is a dict ``{"k": [L, n_pages, page_size, KV, hd], "v": ...}``.
Where the reference returns a new pool (JAX donates the old one), the port
writes the pool in place and returns the same dict.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.kernels.flash_attention import gqa_flash_attention, paged_decode_attention
from repro_torch.models.common import ModelConfig, apply_rope, dense_init, rms_norm

Tree = Any
NEG_INF = -2.0e38


def init_attention(gen: torch.Generator, cfg: ModelConfig, device,
                   n_layers: int | None = None) -> Tree:
    """Attention params; stacked over n_layers when given (leading L axis)."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    L = (n_layers,) if n_layers else ()
    pd = cfg.pdtype
    params = {
        "wq": dense_init(gen, (*L, d, H * hd), fan_in=d, dtype=pd, device=device),
        "wk": dense_init(gen, (*L, d, KV * hd), fan_in=d, dtype=pd, device=device),
        "wv": dense_init(gen, (*L, d, KV * hd), fan_in=d, dtype=pd, device=device),
        "wo": dense_init(gen, (*L, H * hd, d), fan_in=H * hd, dtype=pd, device=device),
    }
    if cfg.qk_norm:
        params["q_norm_scale"] = torch.zeros((*L, hd), dtype=pd, device=device)
        params["k_norm_scale"] = torch.zeros((*L, hd), dtype=pd, device=device)
    return params


def _project_qkv(p: Tree, cfg: ModelConfig, x: torch.Tensor, kv_x: torch.Tensor):
    """Project to q [B,S,H,hd], k/v [B,Skv,KV,hd] with optional QK-norm."""
    B, S, _ = x.shape
    Skv = kv_x.shape[1]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = cfg.compute_dtype
    q = (x @ p["wq"].to(dt)).reshape(B, S, H, hd)
    k = (kv_x @ p["wk"].to(dt)).reshape(B, Skv, KV, hd)
    v = (kv_x @ p["wv"].to(dt)).reshape(B, Skv, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm_scale"])
        k = rms_norm(k, p["k_norm_scale"])
    return q, k, v


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q [B,Sq,H,hd] x k [B,Sk,KV,hd] -> scores [B,KV,G,Sq,Sk] with G=H/KV
    (query head h reads kv head h // G)."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, hd)
    root = torch.tensor(math.sqrt(hd), dtype=torch.float32).to(q.dtype).item()
    return torch.einsum("bqkgh,bskh->bkgqs", qg, k) / root


def _gqa_out(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs [B,KV,G,Sq,Sk] x v [B,Sk,KV,hd] -> [B,Sq,H*hd]."""
    B, KV, G, Sq, Sk = probs.shape
    hd = v.shape[-1]
    o = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
    return o.reshape(B, Sq, KV * G * hd)


def attend(p: Tree, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
           causal: bool = True, return_kv: bool = False):
    """Full-sequence self-attention (prefill).

    ``cfg.attn_impl == 'pallas'`` runs the hand-written flash kernel
    (:func:`repro_torch.kernels.flash_attention.gqa_flash_attention`);
    ``'xla'`` runs the dense softmax in plain torch below
    ``cfg.blockwise_threshold``. Rows attend by absolute position
    (``positions == arange(S)``). ``return_kv=True`` also returns the
    post-RoPE ``(k, v)`` ([B, S, KV, hd] each) for filling a KV cache.
    """
    q, k, v = _project_qkv(p, cfg, x, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    B, S = x.shape[:2]
    if cfg.attn_impl == "pallas":
        o = gqa_flash_attention(
            q, k, v, causal=causal,
            window=cfg.sliding_window if causal else 0,
            block_q=cfg.attn_block_q, block_kv=cfg.attn_block_kv)
        o = o.reshape(B, S, -1)
    elif S >= cfg.blockwise_threshold:
        raise NotImplementedError(
            f"attn_impl='xla' at S={S} >= blockwise_threshold needs "
            "_blockwise_attention, which comes with the training slice (ROADMAP.md)")
    else:
        scores = _gqa_scores(q, k).float()  # [B,KV,G,S,S]
        if causal:
            i = positions if positions.ndim == 1 else positions[0]
            mask = i[:, None] >= i[None, :]
            if cfg.sliding_window:
                mask &= i[:, None] - i[None, :] < cfg.sliding_window
            scores = torch.where(mask[None, None, None], scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        o = _gqa_out(probs, v)
    out = o @ p["wo"].to(cfg.compute_dtype)
    if return_kv:
        return out, (k, v)
    return out


def init_paged_cache(cfg: ModelConfig, n_pages: int, page_size: int, n_layers: int,
                     device, dtype: torch.dtype | None = None) -> Tree:
    """Paged KV pool ``[L, n_pages, page_size, KV, hd]``; page 0 is the
    reserved null page (see ``repro_torch.serving.paging``)."""
    dt = dtype or cfg.compute_dtype
    shape = (n_layers, n_pages, page_size, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def paged_attend_decode(p: Tree, cfg: ModelConfig, x: torch.Tensor, cache_layer: Tree,
                        page_table: torch.Tensor, lengths: torch.Tensor,
                        impl: str = "xla") -> tuple[torch.Tensor, Tree]:
    """Decode one token per slot against one layer of the paged pool.

    x ``[B, 1, d]``; cache k/v ``[n_pages, page_size, KV, hd]`` (views into
    the pool, written in place); ``page_table`` ``[B, max_pages]`` int32;
    ``lengths`` ``[B]`` int32 — slot b's new token sits at position
    ``lengths[b]``. Writes the new K/V into each slot's current page, then
    attends over the slot's own pages.
    """
    B = x.shape[0]
    ps = cache_layer["k"].shape[1]
    max_pages = page_table.shape[1]
    q, k_new, v_new = _project_qkv(p, cfg, x, x)
    posb = lengths[:, None]  # [B, 1] per-slot positions
    q = apply_rope(q, posb, cfg.rope_theta)
    k_new = apply_rope(k_new, posb, cfg.rope_theta)

    # page/slot of the new token; the clamp keeps slots that decode past their
    # allocation (finished requests padding out a span) writing into the null
    # page. Several such slots can hit the same (page 0, slot): duplicate
    # indices in index_put_ leave one of their values there, which is harmless
    # because the null page is garbage by design and always masked.
    page_of = torch.clamp(lengths // ps, max=max_pages - 1)
    page_ids = torch.gather(page_table, 1, page_of[:, None].long())[:, 0]
    slot = lengths % ps
    idx = (page_ids.long(), slot.long())
    cache_layer["k"].index_put_(idx, k_new[:, 0])
    cache_layer["v"].index_put_(idx, v_new[:, 0])

    o = paged_decode_attention(q[:, 0], cache_layer["k"], cache_layer["v"], page_table,
                               lengths + 1, window=cfg.sliding_window, impl=impl)
    out = o.reshape(B, 1, -1) @ p["wo"].to(cfg.compute_dtype)
    return out, cache_layer


def fill_paged_cache(cache_layer: Tree, k: torch.Tensor, v: torch.Tensor,
                     page_table: torch.Tensor, lengths: torch.Tensor) -> Tree:
    """Scatter batched-prefill K/V ([B, P, KV, hd]) into pages, in place.

    Position t of slot b lands in page ``page_table[b, t // ps]`` at slot
    ``t % ps``; positions at or past ``lengths[b]`` (prompt padding) are
    redirected to the null page 0.
    """
    B, P = k.shape[:2]
    ps = cache_layer["k"].shape[1]
    max_pages = page_table.shape[1]
    pos = torch.arange(P, device=k.device)[None, :]  # [1, P]
    page_of = torch.clamp(pos // ps, max=max_pages - 1).expand(B, P)
    page_ids = torch.gather(page_table.long(), 1, page_of)
    page_ids = torch.where(pos < lengths[:, None], page_ids, 0)  # [B, P]
    slot = (pos % ps).expand(B, P)
    idx = (page_ids.reshape(-1), slot.reshape(-1))
    cache_layer["k"].index_put_(idx, k.reshape(B * P, *k.shape[2:]))
    cache_layer["v"].index_put_(idx, v.reshape(B * P, *v.shape[2:]))
    return cache_layer
