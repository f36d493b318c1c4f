"""Pseudogradient compressors (port of ``repro/core/compression.py``; paper
§2, §6.3): top-k sparsification and linear / statistical quantization, each
in global and row-wise variants.

The transform-stack stages at the bottom (``compress`` / ``error_feedback``)
are wire-format-faithful: they emit real wire buffers
(:mod:`repro_torch.core.wire`), and the EF residual is computed against the
reconstruction the receiver decodes from those buffers. The collective
layer (:mod:`repro_torch.core.collectives`) moves and reduces the buffers
with the paper's two quantize / dequantize points.

The tensor functions above them keep the reference's value semantics: they
return the dequantized tensor the receiver would reconstruct.

Arithmetic follows the reference as XLA compiles it: the EF accumulate
``ef_decay * e + d`` is one fused multiply-add (:func:`fma_f32`), and a
level count divides through its fp32 reciprocal. ``quantile`` sorts and
interpolates as ``jnp.quantile``'s ``'linear'`` method does, so it takes
rows of any length (``torch.quantile`` refuses more than 2^24 entries).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.kernels.quantize import fma_f32
from repro_torch.utils.tree import tree_map, tree_unzip

Tree = Any


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    kind: str = "none"  # none | topk | quant
    # top-k
    topk_frac: float = 0.01  # fraction of entries kept
    # quantization
    bits: int = 4
    quant_mode: str = "linear"  # linear | statistical
    rowwise: bool = False
    # error feedback (Karimireddy et al., 2019; paper Alg. 2)
    error_feedback: bool = False
    ef_decay: float = 0.9
    # collective model: 'a2a_rs_ag' = all-to-all reduce-scatter + ring
    # all-gather (2 quantizations); 'gather' = all-gather + local reduce
    # (1 quantization, used for top-k)
    collective: str = "a2a_rs_ag"
    # wire-buffer backend for linear quantization: 'pallas' routes encode /
    # decode through the Hopper quantize / dequantize kernels (their plain
    # versions on the CPU), 'jnp' through plain torch with the same
    # arithmetic. Statistical quantization and top-k are always plain torch.
    wire_impl: str = "pallas"

    def compression_ratio(self) -> float:
        """Approximate wire-bytes ratio vs fp32 — the modeled number (no
        metadata rows, index widths or packing padding); the measured
        accounting (``collectives.measured_sync_bytes``) supersedes it."""
        if self.kind == "none":
            return 1.0
        if self.kind == "topk":
            # value (fp32) + index (~log2 n ~ 32 bits) per kept entry
            return self.topk_frac * 2.0
        if self.kind == "quant":
            return self.bits / 32.0
        raise ValueError(self.kind)


# ---------------------------------------------------------------------------
# Top-k sparsification
# ---------------------------------------------------------------------------


def topk_sparsify(x: torch.Tensor, frac: float) -> torch.Tensor:
    """Keep exactly k = round(frac * n) (at least 1) largest-|.| entries."""
    flat = x.reshape(-1)
    n = flat.shape[0]
    k = max(int(round(frac * n)), 1)
    _, idx = torch.topk(torch.abs(flat), k)
    mask = torch.zeros((n,), dtype=torch.bool, device=x.device)
    mask[idx] = True
    return torch.where(mask, flat, torch.zeros_like(flat)).reshape(x.shape)


# ---------------------------------------------------------------------------
# Linear quantization
# ---------------------------------------------------------------------------


def _row_reduce(x: torch.Tensor, fn, rowwise: bool) -> torch.Tensor:
    if rowwise and x.dim() >= 2:
        return fn(x, dim=-1, keepdim=True)
    return fn(x)


def quantize_linear(x: torch.Tensor, bits: int, rowwise: bool = False) -> torch.Tensor:
    """Uniform levels over [min, max] (global or per last-axis row)."""
    x32 = x.float()
    lo = _row_reduce(x32, torch.amin, rowwise)
    hi = _row_reduce(x32, torch.amax, rowwise)
    nlevels = (1 << bits) - 1
    scale = (hi - lo) * torch.full((), 1.0 / nlevels, dtype=torch.float32, device=x.device)
    scale = torch.where(scale <= 0, torch.ones_like(scale), scale)
    q = torch.round((x32 - lo) / scale)
    return fma_f32(q, scale, lo).to(x.dtype)


# ---------------------------------------------------------------------------
# Statistical (quantile codebook) quantization
# ---------------------------------------------------------------------------


def quantile_levels(rows: torch.Tensor, bits: int) -> torch.Tensor:
    """``[m, n]`` fp32 -> the ``[m, 2^bits]`` codebook: each row's empirical
    quantiles at (i + 0.5) / 2^bits, by ``jnp.quantile``'s ``'linear'``
    method (fp32 positions q * (n - 1), the two neighbours of each, weighted
    by the fraction); a row holding a NaN gets NaN levels."""
    m, n = rows.shape
    nlevels = 1 << bits
    f32 = dict(dtype=torch.float32, device=rows.device)
    qs = (torch.arange(nlevels, **f32) + 0.5) / nlevels
    top = torch.full((), float(n), **f32) - 1.0  # fp32, as jnp.quantile forms n - 1
    pos = qs * top
    low, high = torch.floor(pos), torch.ceil(pos)
    high_w = pos - low
    low_w = 1.0 - high_w
    low = torch.clamp(low, min=0.0, max=top).long()
    high = torch.clamp(high, min=0.0, max=top).long()
    nan_row = torch.isnan(rows).any(dim=1, keepdim=True)
    srt = torch.sort(torch.where(nan_row, torch.nan, rows), dim=1).values
    # low * low_w + high * high_w with the first product fused, as XLA forms it
    return fma_f32(srt[:, low], low_w, srt[:, high] * high_w)


def _codebook_codes(rows: torch.Tensor, levels: torch.Tensor) -> torch.Tensor:
    """Nearest level of each entry by midpoint bucketing (``searchsorted``
    on the level midpoints, left side, as ``jnp.searchsorted``)."""
    mids = 0.5 * (levels[:, 1:] + levels[:, :-1])
    return torch.searchsorted(mids.contiguous(), rows.contiguous())


def quantize_statistical(x: torch.Tensor, bits: int, rowwise: bool = False) -> torch.Tensor:
    """Codebook levels at empirical quantiles (i+0.5)/2^bits; nearest-level
    assignment via midpoint bucketing."""
    x32 = x.float()
    rows = (x32.reshape(-1, x32.shape[-1]) if rowwise and x.dim() >= 2
            else x32.reshape(1, -1))
    levels = quantile_levels(rows, bits)
    out = torch.gather(levels, 1, _codebook_codes(rows, levels))
    return out.reshape(x32.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


def compress_tensor(x: torch.Tensor, cfg: CompressionConfig) -> torch.Tensor:
    if cfg.kind == "none":
        return x
    if cfg.kind == "topk":
        return topk_sparsify(x, cfg.topk_frac)
    if cfg.kind == "quant":
        fn = quantize_linear if cfg.quant_mode == "linear" else quantize_statistical
        return fn(x, cfg.bits, cfg.rowwise)
    raise ValueError(f"unknown compressor {cfg.kind!r}")


def compress_tree(tree: Tree, cfg: CompressionConfig) -> Tree:
    if cfg.kind == "none":
        return tree
    return tree_map(lambda x: compress_tensor(x, cfg), tree)


# ---------------------------------------------------------------------------
# Error feedback (paper Alg. 2 lines 13-17)
# ---------------------------------------------------------------------------


def ef_accumulate(cfg: CompressionConfig, d: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """E <- beta * E + delta in fp32, one fused multiply-add as XLA forms it."""
    beta = torch.full((), cfg.ef_decay, dtype=torch.float32, device=e.device)
    return fma_f32(beta, e.float(), d.float())


def ef_compress_tree(delta: Tree, residual: Tree, cfg: CompressionConfig) -> tuple[Tree, Tree]:
    """E <- beta*E + delta; comm = C(E); E <- E - comm. Returns (comm, E)."""

    def per_leaf(d, e):
        acc = ef_accumulate(cfg, d, e)
        comm = compress_tensor(acc, cfg)
        return comm.to(d.dtype), acc - comm

    return tree_unzip(tree_map(per_leaf, delta, residual), 2)


# ---------------------------------------------------------------------------
# Transform-stack stages (the worker side of the pseudogradient chain):
# they emit repro_torch.core.wire packets, which the reduce stage
# (collectives.reduce_mean) moves and decodes.
# ---------------------------------------------------------------------------


def compress(cfg: CompressionConfig):
    """Stateless worker-side compression on [K, ...]-stacked deltas: emits
    the Q1 / top-k wire buffers (the K axis folds into the row axis, so one
    kernel call encodes every worker); ``kind='none'`` passes the dense
    deltas through untouched."""
    from repro_torch.core.wire import encode_tree
    from repro_torch.optim.transform import stateless

    if cfg.kind == "none":
        return stateless(lambda deltas, _params: deltas)
    return stateless(lambda deltas, _params: encode_tree(deltas, cfg, batch_ndim=1))


def error_feedback(cfg: CompressionConfig):
    """Error-feedback compression as a stateful transform on [K, ...] deltas.

    State is the K-stacked residual tree E (allocated by ``diloco_init`` in
    the optimizer ``state_dtype``). Per Alg. 2: ``E <- beta*E + delta``, the
    wire buffers ``W = Enc(E)`` go downstream, and the new residual is
    ``E - Dec(W)``, against the reconstruction the receiver decodes."""
    from repro_torch.core.wire import decode_leaf, encode_leaf
    from repro_torch.optim.transform import Transform

    def init(stacked_template: Tree) -> Tree:
        return tree_map(torch.zeros_like, stacked_template)

    def update(deltas: Tree, residuals: Tree, params: Tree):
        def per_leaf(d, e):
            acc = ef_accumulate(cfg, d, e)
            w = encode_leaf(acc, cfg, batch_ndim=1)
            return w, acc - decode_leaf(w, impl=cfg.wire_impl)

        comm, new_res = tree_unzip(tree_map(per_leaf, deltas, residuals), 2)
        return comm, new_res

    return Transform(init=init, update=update)
