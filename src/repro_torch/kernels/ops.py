"""Public wrappers around the Hopper kernels of the optimizer and
pseudogradient paths (port of the matmul / Newton–Schulz, quantize and
outer-update parts of ``repro/kernels/ops.py``).

The reference pads operands to block multiples and vmaps its 2-D kernel
over a stacked leaf; the port's kernels mask ragged edges and take the
stack axis themselves, so nothing is padded and one launch covers a whole
``[L, m, n]`` leaf. Each wrapper reads the mesh routing
(``kernels/partition.py``) per call: with none installed it runs as one
process on the whole tensor; on a mesh it runs its kernel on the rank's
local block by the spec its kernel module declares (``matmul.ns_stack_spec``,
``quantize.rowwise_specs``, ``outer_update.outer_update_spec``), which the
kernels' row and element independence makes bitwise the whole call.

The reference's ``block`` and ``block_rows`` arguments pick the kernels'
build variant here: None (the default) consults the autotune table
(:mod:`repro_torch.kernels.autotune`) for a CUDA tensor, under the key of
the stack (Newton–Schulz) or of the wire shape and bits (quantize), and
takes the default tile on a miss or with the table off; a config dict names
a candidate of ``matmul.TILE_CANDIDATES`` or ``quantize.TILE_CANDIDATES``.
Every variant gives the same bits. On the CPU the plain versions take no
tile, and the arguments change nothing.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import autotune
from repro_torch.kernels.matmul import matmul_epilogue
from repro_torch.kernels.matmul import ns_stack_spec
from repro_torch.kernels.outer_update import fused_nesterov_update, outer_update_spec
from repro_torch.kernels.partition import active_partitioning, shard_wrap
from repro_torch.kernels.quantize import (
    rowwise_dequantize,
    rowwise_quantize,
    rowwise_quantize_codes,
    rowwise_specs,
)
from repro_torch.optim.muon import NS_COEFFS


def _tile(knob, device: torch.device) -> dict | None:
    """A call's tile: the config dict given, or None (the default) for a
    CPU tensor or an int knob there (the reference's ``block`` /
    ``block_rows``, which the plain versions do not take); an int on the card
    raises, as the Hopper kernels' knobs are a config."""
    if isinstance(knob, dict) or knob is None:
        return knob
    if device.type == "cpu":
        return None
    raise TypeError(f"the Hopper kernels take a tile config (dict), not {knob!r}")


def matmul(a: torch.Tensor, b: torch.Tensor, d: torch.Tensor | None = None, *,
           alpha: float = 1.0, beta: float = 0.0, symmetric: bool = False,
           tile: dict | None = None) -> torch.Tensor:
    """C = alpha * a@b + beta * d (2-D or stacked 3-D operands, any strides);
    ``symmetric=True`` promises a@b and d symmetric (one triangle computed);
    ``tile`` the kernel's build variant (None: the default)."""
    return matmul_epilogue(a, b, d, alpha=alpha, beta=beta, symmetric=symmetric, tile=tile)


def _ns_iteration(x: torch.Tensor, tile: dict | None = None) -> torch.Tensor:
    """One quintic iteration on a stack [z, m, n] (m <= n): three launches,
    each of ``tile``'s variant. X Xᵀ is symmetric, and so is c·A·A + b·A
    since the kernel's A is bitwise symmetric: both compute one triangle of
    tiles."""
    a, b, c = NS_COEFFS
    xt = x.transpose(-1, -2)                                           # a view, read through strides
    A = matmul(x, xt, symmetric=True, tile=tile)                       # X X^T
    B = matmul(A, A, d=A, alpha=c, beta=b, symmetric=True, tile=tile)  # c*A@A + b*A (fused)
    return matmul(B, x, d=x, alpha=1.0, beta=a, tile=tile)             # B@X + a*X (fused)


def _pairwise_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim in a fixed pairwise order, halves added
    elementwise (an odd width carries its last column to the next level):
    the order depends on the width alone."""
    while x.shape[-1] > 1:
        w = x.shape[-1]
        h = w // 2
        head = x[..., :h] + x[..., h:2 * h]
        x = torch.cat([head, x[..., 2 * h:]], dim=-1) if w % 2 else head
    return x[..., 0]


def frobenius(x3: torch.Tensor) -> torch.Tensor:
    """Each matrix's Frobenius norm, [z, 1, 1], of a stack [z, m, n]: its
    squares summed along each row, then the row sums, both by
    :func:`_pairwise_sum`. PyTorch's own reductions pick their thread layout
    on the card by how many outputs there are (here z), so a rank's block of
    a stack would sum in another order than the whole stack; these sums do
    not, and the block normalizes to the whole stack's bits
    (``kernels/partition.py``)."""
    return torch.sqrt(_pairwise_sum(_pairwise_sum(x3 * x3)))[:, None, None]


def _ns_stack(g3: torch.Tensor, *, iters: int, eps: float,
              tile: dict | None = None) -> torch.Tensor:
    """[z, m, n] -> orthogonalized [z, m, n]: fp32 normalisation
    (:func:`frobenius` of the stack as laid out), transposed (as a view) when
    m > n, then ``iters`` iterations of ``tile``'s variant."""
    m, n = g3.shape[-2:]
    x = g3.float().contiguous()
    x = x / (frobenius(x) + eps)
    transpose = m > n
    if transpose:
        x = x.transpose(-1, -2)
    for _ in range(iters):
        x = _ns_iteration(x, tile)
    if transpose:
        x = x.transpose(-1, -2)
    return x.to(g3.dtype).contiguous()


def ns_orthogonalize(g: torch.Tensor, iters: int = 5, eps: float = 1e-7,
                     block: dict | int | None = None) -> torch.Tensor:
    """Newton–Schulz orthogonalization of the trailing 2 dims through the
    matmul-epilogue kernel, in fp32 (the reference's ``ns_impl='pallas'``
    numeric mode). Leading dims fold into the kernel's batch axis.
    ``block=None`` consults the autotune table on the card for the stack
    ``[L, m, n]`` the launches cover (``autotune.ns_block``) and takes the
    default tile on a miss.

    On a mesh the stack axis splits over ``ns_axes`` (the reference's
    ('data',)): each rank runs its share of the stack and the results are
    gathered whole. A plain operand is a worker's whole momentum, the same
    on every 'data' rank (its gradients were averaged there), so this call,
    and no other kernel's, takes plain operands whole (``plain_whole``)."""
    *batch, m, n = g.shape
    part = active_partitioning()
    if part is None:
        return _ns_local(g.reshape((-1, m, n)), iters, eps, block).reshape(g.shape)
    g3 = g.reshape((-1, m, n))
    spec = ns_stack_spec(part, g3.shape[0])
    fn = shard_wrap(lambda x: _ns_local(x, iters, eps, block),
                    dataclasses.replace(part, plain_whole=True), (spec,), spec)
    return fn(g3).reshape(g.shape)


def _ns_local(g3: torch.Tensor, iters: int, eps: float, block) -> torch.Tensor:
    """The stack [z, m, n] of one process (or one rank's block), with the
    tile ``block`` names or the autotune table's for this stack."""
    z, m, n = g3.shape
    if block is None and g3.device.type == "cuda":
        block = autotune.ns_block(m, n, autotune.dtype_name(g3.dtype), "cuda", stack=z)
    return _ns_stack(g3, iters=iters, eps=eps, tile=_tile(block, g3.device))


def nesterov_update(theta: torch.Tensor, psi: torch.Tensor, u: torch.Tensor, *,
                    lr: float, momentum: float):
    """Fused outer Nesterov update on arbitrary-shaped tensors: flattened,
    one launch, reshaped back. Returns (theta' in theta's dtype, u' fp32)."""
    def local(t, p, uu):
        t2, u2 = fused_nesterov_update(t.reshape(-1), p.reshape(-1).float(),
                                       uu.reshape(-1).float(), lr=lr, momentum=momentum)
        return t2.reshape(t.shape), u2.reshape(t.shape)

    part = active_partitioning()
    if part is None:
        return local(theta, psi, u)
    spec = outer_update_spec(part, tuple(theta.shape))
    return shard_wrap(local, part, (spec, spec, spec), (spec, spec))(theta, psi.float(), u.float())


def _quantize_tile(block_rows, rows: int, cols: int, bits: int, dtype, device) -> dict | None:
    """``block_rows`` as a tile; None consults the autotune table on the card
    under ``(rows, cols, bits)``."""
    if block_rows is None and device.type == "cuda":
        block_rows = autotune.quantize_block_rows(rows, cols, bits,
                                                  autotune.dtype_name(dtype), "cuda")
    return _tile(block_rows, device)


def quantize_tile(x: torch.Tensor, bits: int, block_rows: dict | int | None = None
                  ) -> dict | None:
    """The tile a quantize of ``x [rows, cols]`` at ``bits`` launches:
    ``block_rows`` as given, or for None the autotune table's entry on the
    card (``autotune.quantize_block_rows`` of the wire shape and ``bits``;
    the wire path's codes-only encode takes it too)."""
    return _quantize_tile(block_rows, *x.shape, bits, x.dtype, x.device)


def quantize_rowwise(x: torch.Tensor, bits: int = 4, block_rows: dict | int | None = None):
    """Fused row-wise linear quantize -> dequantize of ``x [rows, cols]``:
    ``(dequantized fp32, codes u8, lo [rows, 1], scale [rows, 1])``. Any row
    count; ``block_rows`` as :func:`quantize_tile` reads it."""
    def local(xb):
        return rowwise_quantize(xb, bits, tile=quantize_tile(xb, bits, block_rows))

    part = active_partitioning()
    if part is None:
        return local(x)
    mat, meta = rowwise_specs(part, x.shape[0])
    return shard_wrap(local, part, (mat,), (mat, mat, meta, meta))(x)


def quantize_codes_rowwise(x: torch.Tensor, bits: int, block_rows: dict | int | None = None,
                           *, encode=None):
    """The wire path's codes-only encode of ``x [rows, cols]``: ``(codes u8,
    lo [rows, 1], scale [rows, 1])`` from the ``quantize`` kernel with no
    dequantized output (``encode``, default ``quantize.rowwise_quantize_codes``),
    routed on a mesh as :func:`quantize_rowwise`."""
    encode = encode or rowwise_quantize_codes

    def local(xb):
        return encode(xb, bits, tile=quantize_tile(xb, bits, block_rows))

    part = active_partitioning()
    if part is None:
        return local(x)
    mat, meta = rowwise_specs(part, x.shape[0])
    return shard_wrap(local, part, (mat,), (mat, meta, meta))(x)


def dequantize_rowwise(codes: torch.Tensor, lo: torch.Tensor, scale: torch.Tensor,
                       block_rows: dict | int | None = None) -> torch.Tensor:
    """The receiver's reconstruction: ``(codes u8 [rows, cols], lo, scale)``
    -> fp32 values. ``block_rows=None`` resolves through the autotune table
    under the reference's key for the receiver, the wire shape at bits 4 in
    float32, so both ends of a 4-bit wire launch from the same variant."""
    def local(c, lo_b, scale_b):
        tile = _quantize_tile(block_rows, *c.shape, 4, torch.float32, c.device)
        return rowwise_dequantize(c, lo_b, scale_b, tile=tile)

    part = active_partitioning()
    if part is None:
        return local(codes, lo, scale)
    mat, meta = rowwise_specs(part, codes.shape[0])
    return shard_wrap(local, part, (mat, meta, meta), mat)(codes, lo, scale)
