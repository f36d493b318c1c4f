"""Batched matmul with a fused axpy epilogue — the Newton–Schulz hot spot
(port of ``repro/kernels/matmul.py``).

    C = alpha * (A @ B) + beta * D

One hand-written Hopper kernel (``csrc/matmul_epilogue.cu``) replaces the
reference's ``_matmul_epilogue_kernel``. Where the reference vmaps its
2-D call over a stacked ``[L, m, n]`` leaf, the kernel takes the batch
dimension itself, so one launch covers every layer of a leaf. Operands are
read through their strides: a transposed operand is a view, not a copy.
Full fp32 arithmetic, no TF32, as the reference's fp32 Newton–Schulz mode:
each entry is one fmaf chain over k in order.

What bounds it on the H100 is the fp32 FMA rate (67 TFLOP/s on the CUDA
cores): X Xᵀ on the w_in stack [30, 576, 1536] is 30.6 GFLOP against 146
MB. The kernel keeps the FMA pipes fed: blocks of 256 threads over
``MATMUL_TILE`` x ``MATMUL_TILE`` tiles of C (96 divides the leaves' 192,
576 and 1536), a 6 x 6 register tile a thread, K in steps of
``MATMUL_BK`` through double-buffered shared memory filled by 16-byte
loads (``cp.async`` where the operand's contiguous axis is the one shared
memory wants) while the other buffer is multiplied; the four operand
layouts are template arguments.

``symmetric=True`` (A·B and D symmetric, as X Xᵀ and c·A·A + b·A are in a
Newton–Schulz iteration) computes only the tiles (i, j) with i <= j, in
the row-by-row order :func:`sym_tile` mirrors, and writes each tile's
transpose too. Mirrored entries are the same products in the same order,
so the result is bitwise the full computation's; a timing's bound counts
only the m(m+1)/2 distinct entries a matrix (30 · 576·577/2 · 1536 · 2 =
15.3 GFLOP for X Xᵀ on w_in, 0.229 ms at 67 TFLOP/s).

The tile is a build variant (``tile=``, a config of ``TILE_CANDIDATES``;
None, the default, is the 96-wide design above): the block tile, the K
step and the thread grid, whose register tiles follow from them, are
``-D`` defines of the one source, each candidate its own library
(``_build.VARIANTS``). They change the schedule, never the arithmetic, so
every candidate's output is bitwise the default's; the autotune sweep
(:mod:`repro_torch.kernels.autotune`) picks among them per stack shape.

The wrapper takes the kernel's plain PyTorch version for a tensor that lies
on the CPU; for a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I] + [_LL] * 9 + [_F, _F, _I, _I, _I, _P]
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# csrc/matmul_epilogue.cu's default block tile of C (square) and K step;
# checked against the built library at its first launch
MATMUL_TILE = 96
MATMUL_BK = 16
# a variant's knobs: block tile, K step, thread grid ty x tx (warps of 4 x 8
# threads, so ty % 4 == 0 and tx % 8 == 0); a thread's register tile is
# (tile / ty) x (tile / tx): 4, 6 or 8 a side
DEFAULT_TILE = {"tile": MATMUL_TILE, "bk": MATMUL_BK, "ty": 16, "tx": 16}
# the fixed candidate grid the autotune sweep walks: tiles of 64, 96 and 128,
# K steps of 8, 16 and 32, square register tiles of 4, 6 and 8 wherever the
# tile divides into whole warps (96 x 96 at 8 x 8 does not: 12 threads a row)
TILE_CANDIDATES = tuple(
    {"tile": t, "bk": bk, "ty": t // r, "tx": t // r}
    for t in (64, 96, 128) for r in (4, 6, 8) for bk in (8, 16, 32)
    if t % r == 0 and (t // r) % 8 == 0)


def ns_stack_spec(part, bsz: int) -> tuple:
    """Spec of a [bsz, m, n] Newton-Schulz stack on a mesh: whole matrices
    stay on one rank; the stack axis shards over ``part.ns_axes`` when it
    divides, else the stack runs whole."""
    from repro_torch.kernels.partition import axes_entry, axes_for

    return (axes_entry(axes_for(part, bsz, part.ns_axes)), None, None)


def tile_defines(tile: dict) -> dict[str, int]:
    """The ``-D`` defines that build ``tile`` (``csrc/matmul_epilogue.cu``'s
    ``MM_*``); the default's equal the source's own defaults."""
    tm, tn, threads = tile["tile"] // tile["ty"], tile["tile"] // tile["tx"], tile["ty"] * tile["tx"]
    return {"MM_TILE": tile["tile"], "MM_BK": tile["bk"], "MM_TY": tile["ty"],
            "MM_TX": tile["tx"], "MM_MG": tm // 4, "MM_MT": tm % 4 // 2, "MM_NG": tn // 4,
            "MM_NT": tn % 4 // 2, "MM_MIN_BLOCKS": max(1, 512 // threads)}


def smem_bytes(tile: dict) -> int:
    """Shared memory a block of ``tile`` takes: the two staging buffers of A
    and B, or the staged C tile, whichever is larger."""
    t = tile["tile"]
    return 4 * max(4 * tile["bk"] * (t + 4), t * (t + 1))


def tile_variant(tile: dict | None) -> str | None:
    """The build variant of ``tile`` (None for the default); raises for a
    config outside ``TILE_CANDIDATES``."""
    if tile is None or tile == DEFAULT_TILE:
        return None
    if tile not in TILE_CANDIDATES:
        raise ValueError(f"matmul_epilogue: tile {tile} is not a candidate of the grid "
                         "(matmul.TILE_CANDIDATES)")
    return f"tile{tile['tile']}-bk{tile['bk']}-ty{tile['ty']}-tx{tile['tx']}"


_build.TILES["matmul_epilogue"] = (4, (MATMUL_TILE, MATMUL_TILE, MATMUL_BK,
                                       DEFAULT_TILE["ty"] * DEFAULT_TILE["tx"]))
for _tile in TILE_CANDIDATES:
    if _tile != DEFAULT_TILE:
        _build.VARIANTS.setdefault("matmul_epilogue", {})[tile_variant(_tile)] = (
            tile_defines(_tile))
        _build.TILES[_build.variant_key("matmul_epilogue", tile_variant(_tile))] = (
            4, (_tile["tile"], _tile["tile"], _tile["bk"], _tile["ty"] * _tile["tx"]))


def sym_tile(t: int, nt: int) -> tuple[int, int]:
    """(i, j), i <= j: the tile that block ``t`` of a symmetric call over
    ``nt`` x ``nt`` tiles computes (the upper triangle, row by row: row i
    holds tiles i .. nt - 1), as the kernel maps its linear block index."""
    i = 0
    while t >= nt - i:
        t -= nt - i
        i += 1
    return i, i + t


def sym_grid(m: int, tile: dict | None = None) -> list[tuple[int, int]]:
    """The tiles (i, j) the blocks of a symmetric ``m x m`` call with
    ``tile`` (None: the default) compute, in block order."""
    t = (tile or DEFAULT_TILE)["tile"]
    nt = -(-m // t)
    return [sym_tile(b, nt) for b in range(nt * (nt + 1) // 2)]


def _matmul_plain(a, b, d, *, alpha: float, beta: float, out_dtype):
    """Plain version of ``matmul_epilogue``: fp32 product, then the epilogue
    in the reference's order (``alpha * acc``, then ``+ beta * d``)."""
    out = alpha * torch.matmul(a.float(), b.float())
    if d is not None and beta != 0.0:
        out = out + beta * d.float()
    return out.to(out_dtype)


def _matmul_cuda(a, b, d, *, alpha: float, beta: float, out_dtype, symmetric: bool = False,
                 tile: dict | None = None):
    if a.dtype not in _DTYPE_CODE:
        raise TypeError(f"matmul_epilogue: dtype {a.dtype} (kernel takes float32 or bfloat16)")
    use_d = d is not None and beta != 0.0
    for t in (b, *((d,) if use_d else ())):
        if t.dtype != a.dtype or t.device != a.device:
            raise TypeError(f"matmul_epilogue: operands {a.dtype}/{a.device} and "
                            f"{t.dtype}/{t.device}")
    if out_dtype != a.dtype:
        raise TypeError(f"matmul_epilogue: out_dtype {out_dtype} != operand dtype {a.dtype}")
    z, m, k = a.shape
    n = b.shape[-1]
    if b.shape != (z, k, n) or (use_d and d.shape != (z, m, n)):
        raise ValueError(f"matmul_epilogue: a {tuple(a.shape)}, b {tuple(b.shape)}, "
                         f"d {None if d is None else tuple(d.shape)}")
    c = torch.empty((z, m, n), dtype=a.dtype, device=a.device)
    dd = d if use_d else c  # never read with use_d = 0
    _build.launch("matmul_epilogue", _ARGTYPES, a.device, a.data_ptr(), b.data_ptr(),
                  dd.data_ptr(), c.data_ptr(), z, m, n, k, *a.stride(), *b.stride(),
                  *dd.stride(), alpha, beta, int(use_d), int(symmetric), _DTYPE_CODE[a.dtype],
                  variant=tile_variant(tile))
    return c


def matmul_epilogue(a: torch.Tensor, b: torch.Tensor, d: torch.Tensor | None = None, *,
                    alpha: float = 1.0, beta: float = 0.0,
                    out_dtype: torch.dtype | None = None,
                    symmetric: bool = False, tile: dict | None = None) -> torch.Tensor:
    """C = alpha * (a @ b) + beta * d for ``[m, k] @ [k, n]`` or stacked
    ``[z, m, k] @ [z, k, n]`` operands of any strides (no padding: the
    kernel masks ragged edges). ``d=None`` or ``beta=0`` never reads d.
    ``symmetric=True`` promises that a @ b and d are symmetric: the kernel
    computes one triangle of tiles and mirrors it (the plain version
    ignores it); a non-square product or d raises ``ValueError``. ``tile``
    picks the kernel's build variant (a config of ``TILE_CANDIDATES``; None,
    the default tile); every variant gives the same bits, and the plain
    version ignores it."""
    out_dtype = out_dtype or a.dtype
    if symmetric and (a.shape[-2] != b.shape[-1]
                      or (d is not None and d.shape[-1] != d.shape[-2])):
        raise ValueError(f"matmul_epilogue: symmetric=True needs a square product and d, got "
                         f"a {tuple(a.shape)}, b {tuple(b.shape)}, "
                         f"d {None if d is None else tuple(d.shape)}")
    tile_variant(tile)  # a config outside the grid raises on either device
    if a.device.type == "cpu":
        return _matmul_plain(a, b, d, alpha=alpha, beta=beta, out_dtype=out_dtype)
    squeeze = a.dim() == 2
    if squeeze:
        a, b = a[None], b[None]
        d = None if d is None else d[None]
    c = _matmul_cuda(a, b, d, alpha=float(alpha), beta=float(beta), out_dtype=out_dtype,
                     symmetric=symmetric, tile=tile)
    return c[0] if squeeze else c
