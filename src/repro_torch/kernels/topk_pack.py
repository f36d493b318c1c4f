"""Top-k (index, value) wire packing for the sparse pseudogradient collective
(port of ``repro/kernels/topk_pack.py``).

The top-k compressor ships the k largest-|.| entries of each worker delta
as explicit (int32 index, value) pairs; the all-gather + local reduce then
scatters every worker's pairs into a dense accumulator. Plain PyTorch, as
the reference's are XLA gather / scatter ops and not a Pallas kernel.

``torch.topk`` ranks as ``jax.lax.top_k`` does (largest first), but does not
promise its order among equal magnitudes (``lax.top_k`` keeps the lower
index first); the two agree wherever the magnitudes are distinct.
"""
from __future__ import annotations

import torch


def pack_topk(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``[n]`` -> ``(indices int32 [k], values [k])``: the k largest-|.|
    entries, largest first."""
    flat = x.reshape(-1)
    _, idx = torch.topk(torch.abs(flat), k)
    return idx.to(torch.int32), flat[idx]


def unpack_topk(indices: torch.Tensor, values: torch.Tensor, n: int) -> torch.Tensor:
    """``(indices [k], values [k])`` -> dense ``[n]`` with zeros elsewhere
    (top-k indices are unique, so the scatter has no collisions)."""
    out = torch.zeros((n,), dtype=values.dtype, device=values.device)
    out[indices.long()] = values
    return out
