"""Grouped-query attention with RoPE, QK-norm, sliding window and a paged KV
cache (port of ``repro/models/attention.py``).

Entry points:
  * ``attend``              — full-sequence (training / prefill)
  * ``attend_decode``       — one new token against the dense (or ring) cache
  * ``paged_attend_decode`` — one new token per slot against the paged pool
  * ``fill_paged_cache``    — scatter a batched prefill's K/V into pages
  * ``cross_attend``        — encoder-decoder / VLM cross attention (dense
    softmax in plain torch, as the reference computes it outside any kernel)
  * ``cross_kv``            — a context's cross-attention K/V, once a request

The dense cache is ``{"k": [L, B, W, KV, hd], "v": ...}`` (``init_cache``),
the paged pool ``{"k": [L, n_pages, page_size, KV, hd], "v": ...}``. Where
the reference returns a new cache (JAX donates the old one), the port
writes the cache in place and returns the same dict.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention import (
    gqa_flash_attention,
    paged_decode_attention,
    visited_kv_range,
)
from repro_torch.core.collectives import copy_in, reduce_out, shared_weight
from repro_torch.models.common import ModelConfig, apply_rope, dense_init, rms_norm

Tree = Any
NEG_INF = -2.0e38


def init_attention(gen: torch.Generator, cfg: ModelConfig, device,
                   n_layers: int | None = None, cross: bool = False) -> Tree:
    """Attention params; stacked over n_layers when given (leading L axis).
    ``cross`` adds llama-3.2-vision's tanh ``gate`` (zero: the gated cross
    path starts closed)."""
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
    if cross:
        params["gate"] = torch.zeros(L, dtype=pd, device=device)
    return params


def _project_qkv(p: Tree, cfg: ModelConfig, x: torch.Tensor, kv_x: torch.Tensor):
    """Project to q [B,S,H,hd], k/v [B,Skv,KV,hd] with optional QK-norm. H
    and KV are the heads the weights hold: all of them, or under tensor
    parallelism this rank's H / M and KV / M (``core/collectives.py``),
    whose QK-norm gradients are summed over 'model'."""
    B, S, _ = x.shape
    Skv = kv_x.shape[1]
    hd = cfg.hd
    H, KV = p["wq"].shape[-1] // hd, p["wk"].shape[-1] // hd
    dt = cfg.compute_dtype
    q = (x @ p["wq"].to(dt)).reshape(B, S, H, hd)
    k = (kv_x @ p["wk"].to(dt)).reshape(B, Skv, KV, hd)
    v = (kv_x @ p["wv"].to(dt)).reshape(B, Skv, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, shared_weight(p["q_norm_scale"]))
        k = rms_norm(k, shared_weight(p["k_norm_scale"]))
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
    """Full-sequence self-attention (training / prefill).

    ``cfg.attn_impl == 'pallas'`` runs the hand-written flash kernel
    (:func:`repro_torch.kernels.flash_attention.gqa_flash_attention`);
    ``'xla'`` runs plain torch: the dense softmax below
    ``cfg.blockwise_threshold``, the blockwise online softmax
    (:func:`_blockwise_attention`) at and above it. Rows attend by absolute
    position (``positions == arange(S)``). ``return_kv=True`` also returns
    the post-RoPE ``(k, v)`` ([B, S, KV, hd] each) for filling a KV cache.
    Under tensor parallelism (``core/collectives.py``) the rank runs
    its own heads and the partial outputs of its rows of ``wo`` are summed
    over 'model'.
    """
    x = copy_in(x)
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
        o = _blockwise_attention(cfg, q, k, v, causal=causal, block_q=cfg.attn_block_q,
                                 block_kv=cfg.attn_block_kv)
        o = o.reshape(B, S, -1)
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
    out = reduce_out(o @ p["wo"].to(cfg.compute_dtype))
    if return_kv:
        return out, (k, v)
    return out


def _blockwise_attention(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool, block_q: int = 512, block_kv: int = 1024,
                         skip_blocks: bool = True) -> torch.Tensor:
    """Exact attention through the online-softmax recurrence over kv blocks.

    q [B,S,H,hd], k/v [B,S,KV,hd] -> o [B,S,H,hd], in fp32 inside, O(block_q
    * block_kv) scores a step instead of O(S^2). Each q block walks only its
    visit schedule (:func:`visited_kv_range`, the flash kernels' own: the
    kv blocks below the causal diagonal and inside the sliding window).
    Skipping is bitwise exact, since a fully masked block leaves (m, l, acc)
    unchanged or is cancelled exactly by the next block's zero correction
    (``skip_blocks=False`` walks every block). Each q block runs under
    ``torch.utils.checkpoint``, as the reference ``jax.checkpoint``s it:
    the backward recomputes its kv walk instead of keeping its scores.
    """
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    bq, bkv = min(block_q, S), min(block_kv, S)
    nq, nkv = S // bq, S // bkv
    assert S % bq == 0 and S % bkv == 0, (S, bq, bkv)
    scale = (1.0 / torch.sqrt(torch.tensor(hd, dtype=torch.float32))).item()  # fp32, as XLA's
    window = cfg.sliding_window if causal else 0
    kb = k.reshape(B, nkv, bkv, KV, hd)
    vb = v.reshape(B, nkv, bkv, KV, hd)
    device = q.device

    def q_block(q_i: torch.Tensor, qi: int, lo: int, hi: int) -> torch.Tensor:
        q32 = q_i.float()  # [B, bq, KV, G, hd]
        rows = qi * bq + torch.arange(bq, device=device)
        m = torch.full((B, KV, G, bq), NEG_INF, dtype=torch.float32, device=device)
        l = torch.zeros((B, KV, G, bq), dtype=torch.float32, device=device)
        acc = torch.zeros((B, KV, G, bq, hd), dtype=torch.float32, device=device)
        for kj in range(lo, hi):
            s = torch.einsum("bqkgh,bskh->bkgqs", q32, kb[:, kj].float()) * scale
            cols = kj * bkv + torch.arange(bkv, device=device)
            mask = torch.ones((bq, bkv), dtype=torch.bool, device=device)
            if causal:
                mask &= rows[:, None] >= cols[None, :]
            if window:
                mask &= rows[:, None] - cols[None, :] < window
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bkgqs,bskh->bkgqh", p, vb[:, kj].float())
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]  # [B, KV, G, bq, hd]
        return out.movedim(3, 1)  # [B, bq, KV, G, hd]

    qb = q.reshape(B, nq, bq, KV, G, hd)
    outs = []
    for qi in range(nq):
        lo, hi = ((0, nkv) if not skip_blocks else
                  visited_kv_range(qi, nkv, bq, bkv, causal, window))
        outs.append(checkpoint(q_block, qb[:, qi], qi, lo, hi, use_reentrant=False))
    return torch.stack(outs, dim=1).reshape(B, S, H, hd).to(q.dtype)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, n_layers: int, device,
               dtype: torch.dtype | None = None) -> Tree:
    """Dense KV cache ``[L, batch, cache_len, KV, hd]`` (the naive engine's)."""
    dt = dtype or cfg.compute_dtype
    shape = (n_layers, batch, cache_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def fill_cache_from_prefill(k: torch.Tensor, v: torch.Tensor, cache_layer: Tree) -> Tree:
    """Write full-sequence prefill K/V ([B, S, KV, hd]) into the first S
    positions of one layer's (larger) cache buffers, in place."""
    S = k.shape[1]
    cache_layer["k"][:, :S] = k
    cache_layer["v"][:, :S] = v
    return cache_layer


def attend_decode(p: Tree, cfg: ModelConfig, x: torch.Tensor, cache_layer: Tree,
                  pos: int) -> tuple[torch.Tensor, Tree]:
    """Decode one token. x [B, 1, d]; cache k/v [B, W, KV, hd] (one layer,
    written in place); ``pos`` the new token's absolute position.

    With ``cfg.sliding_window`` the cache is a ring buffer of W = window
    slots (slot = pos % W), so decode memory is O(window); slot s holds
    absolute position ``pos - ((pos - s) % W)``, valid when it is >= 0 and
    inside the window. Without it the cache holds absolute positions
    (W >= the sequence length).
    """
    B = x.shape[0]
    q, k_new, v_new = _project_qkv(p, cfg, x, x)
    posb = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, posb, cfg.rope_theta)
    k_new = apply_rope(k_new, posb, cfg.rope_theta)

    W = cache_layer["k"].shape[1]
    slot = pos % W if cfg.sliding_window else pos
    cache_layer["k"][:, slot] = k_new[:, 0]
    cache_layer["v"][:, slot] = v_new[:, 0]

    scores = _gqa_scores(q, cache_layer["k"]).float()  # [B,KV,G,1,W]
    idx = torch.arange(W, device=x.device)
    if cfg.sliding_window:
        slot_pos = pos - ((pos - idx) % W)
        valid = (slot_pos >= 0) & (slot_pos > pos - W)
    else:
        valid = idx <= pos
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    o = _gqa_out(probs, cache_layer["v"])
    out = o @ p["wo"].to(cfg.compute_dtype)
    return out, cache_layer


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


def cross_attend(p: Tree, cfg: ModelConfig, x: torch.Tensor, kv, gated: bool = False
                 ) -> torch.Tensor:
    """Cross attention of x [B, Sq, d] to a context: ``kv`` is the context's
    states [B, Sk, d] or a precomputed ``(k, v)`` pair ([B, Sk, KV, hd]
    each, :func:`cross_kv`) for cached decoding. No mask and no RoPE; with
    ``gated`` the output is scaled by ``tanh(gate)`` in fp32, cast to the
    compute dtype."""
    dt = cfg.compute_dtype
    B, Sq, _ = x.shape
    q = (x @ p["wq"].to(dt)).reshape(B, Sq, cfg.n_heads, cfg.hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm_scale"])
    k, v = kv if isinstance(kv, tuple) else cross_kv(p, cfg, kv)
    probs = torch.softmax(_gqa_scores(q, k).float(), dim=-1).to(x.dtype)
    out = _gqa_out(probs, v) @ p["wo"].to(dt)
    if gated:
        out = torch.tanh(p["gate"].float()).to(dt) * out
    return out


def cross_kv(p: Tree, cfg: ModelConfig, context: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The cross-attention K/V of context states [B, Sk, d] ([B, Sk, KV, hd]
    each, QK-normed when the config has it): computed once a request for
    the decode path."""
    dt = cfg.compute_dtype
    B, Sk, _ = context.shape
    k = (context @ p["wk"].to(dt)).reshape(B, Sk, cfg.n_kv_heads, cfg.hd)
    v = (context @ p["wv"].to(dt)).reshape(B, Sk, cfg.n_kv_heads, cfg.hd)
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm_scale"])
    return k, v
