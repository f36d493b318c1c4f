"""Public wrappers around the Hopper kernels of the optimizer and
pseudogradient paths (port of the matmul / Newton–Schulz, quantize and
outer-update parts of ``repro/kernels/ops.py``).

The reference pads operands to block multiples and vmaps its 2-D kernel
over a stacked leaf; the port's kernels mask ragged edges and take the
stack axis themselves, so nothing is padded and one launch covers a whole
``[L, m, n]`` leaf. Mesh routing (``kernels/partition.py``) comes with the
multi-GPU slice, and the autotune table (``kernels/autotune.py``) with the
tooling slice (ROADMAP.md); the Hopper kernels tile themselves, so the
reference's ``block`` and ``block_rows`` arguments have no counterpart.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.matmul import matmul_epilogue
from repro_torch.kernels.outer_update import fused_nesterov_update
from repro_torch.kernels.quantize import rowwise_dequantize, rowwise_quantize
from repro_torch.optim.muon import NS_COEFFS


def matmul(a: torch.Tensor, b: torch.Tensor, d: torch.Tensor | None = None, *,
           alpha: float = 1.0, beta: float = 0.0, symmetric: bool = False) -> torch.Tensor:
    """C = alpha * a@b + beta * d (2-D or stacked 3-D operands, any strides);
    ``symmetric=True`` promises a@b and d symmetric (one triangle computed)."""
    return matmul_epilogue(a, b, d, alpha=alpha, beta=beta, symmetric=symmetric)


def _ns_iteration(x: torch.Tensor) -> torch.Tensor:
    """One quintic iteration on a stack [z, m, n] (m <= n): three launches.
    X Xᵀ is symmetric, and so is c·A·A + b·A since the kernel's A is
    bitwise symmetric: both compute one triangle of tiles."""
    a, b, c = NS_COEFFS
    xt = x.transpose(-1, -2)                                  # a view, read through strides
    A = matmul(x, xt, symmetric=True)                         # X X^T
    B = matmul(A, A, d=A, alpha=c, beta=b, symmetric=True)    # c*A@A + b*A (fused epilogue)
    return matmul(B, x, d=x, alpha=1.0, beta=a)               # B@X + a*X (fused epilogue)


def _ns_stack(g3: torch.Tensor, *, iters: int, eps: float) -> torch.Tensor:
    """[z, m, n] -> orthogonalized [z, m, n]: fp32 normalisation, transposed
    (as a view) when m > n, then ``iters`` iterations."""
    m, n = g3.shape[-2:]
    x = g3.float()
    transpose = m > n
    if transpose:
        x = x.transpose(-1, -2)
    x = x / (torch.sqrt(torch.sum(x * x, dim=(-2, -1), keepdim=True)) + eps)
    for _ in range(iters):
        x = _ns_iteration(x)
    if transpose:
        x = x.transpose(-1, -2)
    return x.to(g3.dtype).contiguous()


def ns_orthogonalize(g: torch.Tensor, iters: int = 5, eps: float = 1e-7) -> torch.Tensor:
    """Newton–Schulz orthogonalization of the trailing 2 dims through the
    matmul-epilogue kernel, in fp32 (the reference's ``ns_impl='pallas'``
    numeric mode). Leading dims fold into the kernel's batch axis."""
    *batch, m, n = g.shape
    out = _ns_stack(g.reshape((-1, m, n)), iters=iters, eps=eps)
    return out.reshape((*batch, m, n))


def nesterov_update(theta: torch.Tensor, psi: torch.Tensor, u: torch.Tensor, *,
                    lr: float, momentum: float):
    """Fused outer Nesterov update on arbitrary-shaped tensors: flattened,
    one launch, reshaped back. Returns (theta' in theta's dtype, u' fp32)."""
    shape = theta.shape
    t2, u2 = fused_nesterov_update(theta.reshape(-1), psi.reshape(-1).float(),
                                   u.reshape(-1).float(), lr=lr, momentum=momentum)
    return t2.reshape(shape), u2.reshape(shape)


def quantize_rowwise(x: torch.Tensor, bits: int = 4, block_rows: int | None = None):
    """Fused row-wise linear quantize -> dequantize of ``x [rows, cols]``:
    ``(dequantized fp32, codes u8, lo [rows, 1], scale [rows, 1])``. Any row
    count; ``block_rows`` is accepted and changes nothing (every row
    quantizes against its own lo and scale)."""
    return rowwise_quantize(x, bits)


def dequantize_rowwise(codes: torch.Tensor, lo: torch.Tensor, scale: torch.Tensor,
                       block_rows: int | None = None) -> torch.Tensor:
    """The receiver's reconstruction: ``(codes u8 [rows, cols], lo, scale)``
    -> fp32 values. ``block_rows`` is accepted and changes nothing."""
    return rowwise_dequantize(codes, lo, scale)
