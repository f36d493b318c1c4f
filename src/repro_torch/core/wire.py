"""Wire formats for the compressed pseudogradient collectives (port of
``repro/core/wire.py``).

What crosses the wire:

* linear quantization -> :class:`QuantWire`: bit-packed u8 codes (8/bits
  codes per byte, ``kernels/quantize.pack_codes``) plus per-row fp32
  ``lo``/``scale``, produced by the Hopper ``quantize`` kernel's codes-only
  launch (``impl='pallas'``, the reference's name for the kernel route) or
  by plain torch with the same arithmetic (``'jnp'``);
* statistical quantization -> :class:`CodebookWire`: bit-packed codes plus
  the per-row quantile codebook (2^bits fp32 levels);
* top-k -> :class:`TopKWire`: (int32 index, fp32 value) pairs per worker
  (``kernels/topk_pack.py``).

``rowwise=True`` quantizes per last-axis row, otherwise the whole
(per-worker) leaf is one row. Worker-stacked ``[K, ...]`` leaves fold K
into the row axis, so one kernel call encodes all workers. Receivers
reconstruct from the wire buffers only (:func:`decode_leaf`). A packet is a
dataclass, one leaf to ``utils.tree``'s walks; :func:`wire_tree_bytes`
counts the buffers inside it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.kernels.quantize import (
    fma_f32,
    pack_codes,
    quant_codes_plain,
    rowwise_quantize_codes,
    unpack_codes,
)
from repro_torch.utils.tree import tree_leaves, tree_map

Tree = Any


@dataclasses.dataclass(frozen=True)
class QuantWire:
    """Linear-quantization wire buffer: packed codes + per-row (lo, scale)."""

    packed: Any  # uint8 [rows, packed_width(cols, bits)]
    lo: Any  # f32 [rows, 1]
    scale: Any  # f32 [rows, 1]
    shape: tuple  # original leaf shape
    cols: int  # codes per row before packing
    bits: int  # code width


@dataclasses.dataclass(frozen=True)
class CodebookWire:
    """Statistical-quantization wire buffer: packed codes + quantile levels."""

    packed: Any  # uint8 [rows, packed_width(cols, bits)]
    levels: Any  # f32 [rows, 2**bits]
    shape: tuple
    cols: int
    bits: int


@dataclasses.dataclass(frozen=True)
class TopKWire:
    """Sparse wire buffer: (index, value) pairs for the k largest-|.| entries."""

    indices: Any  # int32 [batch?, k]
    values: Any  # f32 [batch?, k]
    shape: tuple


# the buffers of each packet type (the reference's pytree data fields)
_BUFFERS = {QuantWire: ("packed", "lo", "scale"), CodebookWire: ("packed", "levels"),
            TopKWire: ("indices", "values")}


def is_wire(x: Any) -> bool:
    return type(x) in _BUFFERS


def wire_buffers(w: Any) -> list:
    """The buffers a packet carries, in the reference's field order."""
    return [getattr(w, f) for f in _BUFFERS[type(w)]]


# ---------------------------------------------------------------------------
# Row layout: the grouping of the value-semantics compressors
# ---------------------------------------------------------------------------


def _row_layout(shape: tuple, rowwise: bool, batch_ndim: int) -> tuple[int, int]:
    """(rows, cols) of the 2-D view a leaf is quantized in. The first
    ``batch_ndim`` axes (the worker stack K) always separate rows; within a
    batch element ``rowwise`` quantizes per last-axis row when the element
    is >= 2-D, else the whole element is one row."""
    batch = math.prod(shape[:batch_ndim]) if batch_ndim else 1
    inner = shape[batch_ndim:]
    if rowwise and len(inner) >= 2:
        return batch * math.prod(inner[:-1]), inner[-1]
    return batch, math.prod(inner) if inner else 1


# ---------------------------------------------------------------------------
# Leaf encode / decode
# ---------------------------------------------------------------------------


def quant_encode(x: torch.Tensor, bits: int, rowwise: bool, *,
                 batch_ndim: int = 0, impl: str = "pallas") -> QuantWire:
    """Q: leaf -> wire (Q1 worker-side, Q2 on the reduced shard)."""
    if bits > 8:
        raise ValueError("codes are u8 on the wire")
    m, n = _row_layout(tuple(x.shape), rowwise, batch_ndim)
    x2d = x.reshape(m, n)
    if impl == "pallas":  # the codes-only kernel, under ops.quantize_rowwise's autotune key
        from repro_torch.kernels.ops import quantize_codes_rowwise

        codes, lo, scale = quantize_codes_rowwise(x2d, bits, encode=rowwise_quantize_codes)
    else:
        q, lo, scale = quant_codes_plain(x2d, bits)
        codes = q.to(torch.uint8)
    return QuantWire(packed=pack_codes(codes, bits), lo=lo, scale=scale,
                     shape=tuple(x.shape), cols=n, bits=bits)


def codebook_encode(x: torch.Tensor, bits: int, rowwise: bool, *,
                    batch_ndim: int = 0) -> CodebookWire:
    """Statistical (quantile-codebook) encode; codes + levels on the wire."""
    from repro_torch.core.compression import _codebook_codes, quantile_levels

    if bits > 8:
        raise ValueError("codes are u8 on the wire")
    m, n = _row_layout(tuple(x.shape), rowwise, batch_ndim)
    x2d = x.reshape(m, n).float()
    levels = quantile_levels(x2d, bits)
    codes = _codebook_codes(x2d, levels).to(torch.uint8)
    return CodebookWire(packed=pack_codes(codes, bits), levels=levels,
                        shape=tuple(x.shape), cols=n, bits=bits)


def topk_encode(x: torch.Tensor, frac: float, *, batch_ndim: int = 0) -> TopKWire:
    """Pack the k = round(frac * n) (at least 1) largest-|.| entries per
    batch element."""
    from repro_torch.kernels.topk_pack import pack_topk

    inner = math.prod(x.shape[batch_ndim:])
    k = max(int(round(frac * inner)), 1)
    if batch_ndim:
        batch = math.prod(x.shape[:batch_ndim])
        pairs = [pack_topk(v, k) for v in x.reshape(batch, inner)]
        idx, val = torch.stack([i for i, _ in pairs]), torch.stack([v for _, v in pairs])
    else:
        idx, val = pack_topk(x.reshape(inner), k)
    return TopKWire(indices=idx, values=val, shape=tuple(x.shape))


def decode_leaf(w: Any, *, impl: str = "pallas") -> torch.Tensor:
    """The receiver: reconstruct an fp32 leaf from its wire buffers only."""
    from repro_torch.kernels.topk_pack import unpack_topk

    if isinstance(w, QuantWire):
        codes = unpack_codes(w.packed, w.bits, w.cols)
        if impl == "pallas":
            from repro_torch.kernels.ops import dequantize_rowwise

            vals = dequantize_rowwise(codes, w.lo, w.scale)
        else:
            vals = fma_f32(codes.float(), w.scale, w.lo)
        return vals.reshape(w.shape)
    if isinstance(w, CodebookWire):
        codes = unpack_codes(w.packed, w.bits, w.cols)
        return torch.gather(w.levels, 1, codes.long()).reshape(w.shape)
    if isinstance(w, TopKWire):
        n = math.prod(w.shape)
        if w.indices.dim() == 2:  # batched (K-stacked)
            batch = w.indices.shape[0]
            dense = torch.stack([unpack_topk(i, v, n // batch)
                                 for i, v in zip(w.indices, w.values)])
        else:
            dense = unpack_topk(w.indices, w.values, n)
        return dense.reshape(w.shape)
    raise TypeError(f"not a wire packet: {type(w)!r}")


# ---------------------------------------------------------------------------
# Tree-level helpers + byte accounting
# ---------------------------------------------------------------------------


def encode_leaf(x: torch.Tensor, cfg, *, batch_ndim: int = 0, impl: str | None = None):
    """Dispatch on the compression config (kind='none' passes through)."""
    if cfg.kind == "none":
        return x
    if cfg.kind == "topk":
        return topk_encode(x, cfg.topk_frac, batch_ndim=batch_ndim)
    if cfg.kind == "quant":
        if cfg.quant_mode == "statistical":
            return codebook_encode(x, cfg.bits, cfg.rowwise, batch_ndim=batch_ndim)
        return quant_encode(x, cfg.bits, cfg.rowwise, batch_ndim=batch_ndim,
                            impl=impl or cfg.wire_impl)
    raise ValueError(f"unknown compressor {cfg.kind!r}")


def encode_tree(tree: Tree, cfg, *, batch_ndim: int = 0, impl: str | None = None) -> Tree:
    return tree_map(lambda x: encode_leaf(x, cfg, batch_ndim=batch_ndim, impl=impl), tree)


def decode_tree(wire_tree: Tree, cfg, *, impl: str | None = None) -> Tree:
    if cfg.kind == "none":
        return wire_tree
    return tree_map(lambda w: decode_leaf(w, impl=impl or cfg.wire_impl), wire_tree)


def buffer_bytes(x: Any) -> int:
    """Bytes of one buffer (a tensor, or anything with a shape and a torch
    dtype)."""
    return math.prod(x.shape) * x.dtype.itemsize


def wire_tree_bytes(tree: Tree) -> int:
    """Total bytes of every buffer in a (wire-packet or dense) tree."""
    return sum(sum(buffer_bytes(b) for b in wire_buffers(x)) if is_wire(x) else buffer_bytes(x)
               for x in tree_leaves(tree))
