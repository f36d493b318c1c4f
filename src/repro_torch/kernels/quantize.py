"""Row-wise linear quantize / dequantize and code bit-packing (port of
``repro/kernels/quantize.py``).

Per row of a ``[rows, cols]`` fp32 matrix::

    lo    = min(row),  scale = (max(row) - lo) * fl32(1 / (2^bits - 1))
    scale = 1 where scale <= 0            (a constant row)
    codes = round_half_even((x - lo) / scale)   as u8
    deq   = fma(codes, scale, lo)               (one rounding)

Two hand-written Hopper kernels (``csrc/quantize.cu``) replace the
reference's ``_rowwise_quant_kernel`` and ``_rowwise_dequant_kernel``:
``quantize`` writes codes, lo, scale and, unless the caller asks for the
codes alone (:func:`rowwise_quantize_codes`, the wire path's encode), deq;
``dequantize`` rebuilds the values from codes, lo and scale. Each has a
plain PyTorch version here (``rowwise_quantize_plain``,
``quant_codes_plain``, ``rowwise_dequantize_plain``). How ``quantize`` cuts
a call, from its shape alone, is :func:`quantize_plan`.

The arithmetic is the reference's as XLA compiles it, reproduced on purpose
so that codes and values are bitwise the reference's: XLA turns the
division by the constant ``nlevels`` into a multiply by its fp32 reciprocal
and contracts ``lo + q * scale`` into one fused multiply-add. The kernels
use ``__fmul_rn``, ``__fdiv_rn``, ``rintf`` and ``__fmaf_rn``; the plain
versions use :func:`fma_f32`, an exact single-rounded fma in PyTorch.

The kernels' threads a block, long-row unroll and long-row split are build
variants (``tile=``, a config of ``TILE_CANDIDATES``; None, the default):
``-D`` defines of the one source, each candidate its own library. They move
the cuts between the regimes and the split of a long row, never the
arithmetic (min and max are exact, the encode elementwise), so every
candidate's output is bitwise the default's; the autotune sweep picks among
them per ``(rows, cols, bits)``.

The wrappers take the plain version for a tensor on the CPU; for a CUDA
tensor they launch the kernel or raise. Code packing (:func:`pack_codes`,
:func:`unpack_codes`) is plain PyTorch, as in the reference.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_QUANT_ARGTYPES = [_P, _P, _P, _P, _P, _P, _LL, _LL, _I, _P]
_DEQUANT_ARGTYPES = [_P, _P, _P, _P, _LL, _LL, _P]
# csrc/quantize.cu's plan (the default variant's), checked against the
# built library at its first launch: a row of up to WARP_ROW_MAX entries is
# held in one warp's registers and up to BLOCK_ROW_MAX in one block's (read
# once); a longer row is read twice, in steps of LONG_MIN_GROUPS float4
# groups: first by `parts` blocks a row, about LONG_BLOCKS in all, each at
# least one step, then by one block a step
WARP_ROW_MAX = 2048
BLOCK_ROW_MAX = 16384
LONG_BLOCKS = 528
LONG_MIN_GROUPS = 1024
MAX_GROUPS = 16  # float4 groups a thread holds of a row read once
# a variant's knobs: threads a block, float4 groups in flight a thread over a
# long row, the blocks pass 1 of a long call aims at
DEFAULT_TILE = {"threads": 256, "unroll": 4, "long_blocks": LONG_BLOCKS}
# the fixed candidate grid the autotune sweep walks
TILE_CANDIDATES = tuple({"threads": t, "unroll": u, "long_blocks": b}
                        for t in (128, 256, 512) for u in (2, 4, 8) for b in (264, 528, 1056))


def rowwise_specs(part, rows: int) -> tuple[tuple, tuple]:
    """(matrix spec [rows, n], meta spec [rows, 1]) of the encode / decode
    on a mesh: rows are independent (each carries its own lo / scale), so
    the row axis shards over ``part.quantize_axes``; columns stay whole."""
    from repro_torch.kernels.partition import axes_entry, axes_for

    r = axes_entry(axes_for(part, rows, part.quantize_axes))
    return (r, None), (r, None)


def plan_sizes(tile: dict | None = None) -> tuple[int, int, int, int]:
    """``(WARP_ROW_MAX, BLOCK_ROW_MAX, LONG_BLOCKS, LONG_MIN_GROUPS)`` of
    ``tile`` (None: the default), as its library reports them."""
    t = tile or DEFAULT_TILE
    return (32 * MAX_GROUPS * 4, t["threads"] * MAX_GROUPS * 4, t["long_blocks"],
            t["unroll"] * t["threads"])


def tile_defines(tile: dict) -> dict[str, int]:
    """The ``-D`` defines that build ``tile`` (``csrc/quantize.cu``'s ``QZ_*``)."""
    return {"QZ_THREADS": tile["threads"], "QZ_UNROLL": tile["unroll"],
            "QZ_LONG_BLOCKS": tile["long_blocks"]}


def tile_variant(tile: dict | None) -> str | None:
    """The build variant of ``tile`` (None for the default); raises for a
    config outside ``TILE_CANDIDATES``."""
    if tile is None or tile == DEFAULT_TILE:
        return None
    if tile not in TILE_CANDIDATES:
        raise ValueError(f"quantize: tile {tile} is not a candidate of the grid "
                         "(quantize.TILE_CANDIDATES)")
    return f"threads{tile['threads']}-unroll{tile['unroll']}-blocks{tile['long_blocks']}"


_build.TILES["quantize"] = (4, plan_sizes())
for _tile in TILE_CANDIDATES:
    if _tile != DEFAULT_TILE:
        _build.VARIANTS.setdefault("quantize", {})[tile_variant(_tile)] = tile_defines(_tile)
        _build.TILES[_build.variant_key("quantize", tile_variant(_tile))] = (4, plan_sizes(_tile))


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fp32 ``a * b + c`` rounded once, as a fused multiply-add rounds it.

    The product of two fp32 values is exact in fp64. The sum is formed in
    fp64 and rounded to odd (TwoSum gives its error; an inexact sum with an
    even last bit moves one ulp toward the error), and rounding that to fp32
    is then the correctly rounded fma: fp64 carries more than 24 + 2 bits."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = torch.bitwise_and(s.view(torch.int64), 1) == 0
    nudge = (err != 0) & even & torch.isfinite(s)
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    return torch.where(nudge, torch.nextafter(s, toward), s).float()


def _levels(bits: int) -> int:
    if not 1 <= bits <= 8:
        raise ValueError(f"bits = {bits}: codes are u8 on the wire (1 to 8 bits)")
    return (1 << bits) - 1


def quant_codes_plain(x: torch.Tensor, bits: int):
    """The code half of ``quantize`` in plain torch: ``x [rows, cols]`` ->
    ``(q, lo [rows, 1], scale [rows, 1])`` with q the fp32 code values."""
    inv = torch.full((), 1.0 / _levels(bits), dtype=torch.float32, device=x.device)
    x32 = x.float()
    lo = torch.amin(x32, dim=1, keepdim=True)
    hi = torch.amax(x32, dim=1, keepdim=True)
    scale = (hi - lo) * inv
    scale = torch.where(scale <= 0.0, torch.ones_like(scale), scale)
    return torch.round((x32 - lo) / scale), lo, scale


def rowwise_quantize_plain(x: torch.Tensor, bits: int):
    """Plain version of ``quantize``: ``x [rows, cols]`` -> ``(deq fp32,
    codes u8, lo [rows, 1], scale [rows, 1])``."""
    q, lo, scale = quant_codes_plain(x, bits)
    return fma_f32(q, scale, lo), q.to(torch.uint8), lo, scale


def rowwise_dequantize_plain(codes: torch.Tensor, lo: torch.Tensor,
                             scale: torch.Tensor) -> torch.Tensor:
    """Plain version of ``dequantize``: ``fma(codes, scale, lo)`` in fp32."""
    return fma_f32(codes.float(), scale.float(), lo.float())


def _check_rows(name: str, x: torch.Tensor, dtype: torch.dtype) -> tuple[int, int]:
    if x.dim() != 2:
        raise ValueError(f"{name}: expected [rows, cols], got {tuple(x.shape)}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: dtype {x.dtype} (kernel takes {dtype})")
    if not x.is_contiguous():
        raise ValueError(f"{name}: operand must be contiguous")
    return x.shape


def quantize_plan(rows: int, cols: int, tile: dict | None = None) -> tuple[str, int]:
    """``(regime, parts)``: how the ``quantize`` kernel of ``tile`` (None:
    the default) cuts a ``[rows, cols]`` call (``csrc/quantize.cu:
    quantize_plan``). ``'warp'`` and ``'block'`` hold a row in one warp's or
    one block's registers and read it once; ``'long'`` reads it twice, first
    with ``parts`` blocks a row, which leave ``2 * rows * parts`` fp32 of
    partial min and max in the scratch."""
    if rows <= 0 or cols <= 0:
        raise ValueError(f"quantize_plan: empty shape ({rows}, {cols})")
    warp_row_max, block_row_max, long_blocks, long_min_groups = plan_sizes(tile)
    if cols <= warp_row_max:
        return "warp", 1
    if cols <= block_row_max:
        return "block", 1
    return "long", min(-(-long_blocks // rows), -(-cols // 4) // long_min_groups)


def _quantize_cuda(x: torch.Tensor, bits: int, with_deq: bool = True,
                   tile: dict | None = None):
    rows, cols = _check_rows("quantize", x, torch.float32)
    nlevels = _levels(bits)
    deq = torch.empty_like(x) if with_deq else None
    codes = torch.empty((rows, cols), dtype=torch.uint8, device=x.device)
    lo = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    scale = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    if rows and cols:
        regime, parts = quantize_plan(rows, cols, tile)
        partial = (torch.empty((2, rows * parts), dtype=torch.float32, device=x.device)
                   if regime == "long" else None)
        _build.launch("quantize", _QUANT_ARGTYPES, x.device, x.data_ptr(),
                      None if deq is None else deq.data_ptr(), codes.data_ptr(),
                      lo.data_ptr(), scale.data_ptr(),
                      None if partial is None else partial.data_ptr(), rows, cols, nlevels,
                      variant=tile_variant(tile))
    return deq, codes, lo, scale


def _dequantize_cuda(codes: torch.Tensor, lo: torch.Tensor, scale: torch.Tensor,
                     tile: dict | None = None):
    rows, cols = _check_rows("dequantize", codes, torch.uint8)
    for name, t in (("lo", lo), ("scale", scale)):
        if t.shape != (rows, 1) or t.dtype != torch.float32 or t.device != codes.device:
            raise ValueError(f"dequantize: {name} {tuple(t.shape)} {t.dtype} on {t.device}, "
                             f"expected ({rows}, 1) float32 on {codes.device}")
    out = torch.empty((rows, cols), dtype=torch.float32, device=codes.device)
    if rows and cols:
        _build.launch("dequantize", _DEQUANT_ARGTYPES, codes.device, codes.data_ptr(),
                      lo.contiguous().data_ptr(), scale.contiguous().data_ptr(),
                      out.data_ptr(), rows, cols, variant=tile_variant(tile))
    return out


def rowwise_quantize(x: torch.Tensor, bits: int = 4, tile: dict | None = None):
    """``x [rows, cols]`` -> ``(dequantized fp32, codes u8, lo, scale)``.
    Any row count: nothing is padded. ``tile``: the kernel's build variant
    (a config of ``TILE_CANDIDATES``; None, the default); the plain version
    ignores it."""
    tile_variant(tile)  # a config outside the grid raises on either device
    if x.device.type == "cpu":
        return rowwise_quantize_plain(x, bits)
    return _quantize_cuda(x, bits, tile=tile)


def rowwise_quantize_codes(x: torch.Tensor, bits: int = 4, tile: dict | None = None):
    """``x [rows, cols]`` -> ``(codes u8, lo, scale)``: ``rowwise_quantize``
    without the dequantized values, which the kernel then never writes (the
    wire path's encode)."""
    tile_variant(tile)
    if x.device.type == "cpu":
        q, lo, scale = quant_codes_plain(x, bits)
        return q.to(torch.uint8), lo, scale
    return _quantize_cuda(x, bits, with_deq=False, tile=tile)[1:]


def rowwise_dequantize(codes: torch.Tensor, lo: torch.Tensor,
                       scale: torch.Tensor, tile: dict | None = None) -> torch.Tensor:
    """The receiver side: ``(codes u8 [rows, cols], lo [rows, 1], scale
    [rows, 1])`` -> fp32 values, launched from ``tile``'s library (its
    elementwise decode is the same in every variant)."""
    tile_variant(tile)
    if codes.device.type == "cpu":
        return rowwise_dequantize_plain(codes, lo, scale)
    return _dequantize_cuda(codes, lo, scale, tile=tile)


# ---------------------------------------------------------------------------
# Wire byte layout: bit-packing of quantization codes
# ---------------------------------------------------------------------------


def packed_width(n: int, bits: int) -> int:
    """Bytes per row of n codes at the given width (ceil; 1 byte/code when
    bits does not divide 8)."""
    if 8 % bits:
        return n
    per = 8 // bits
    return (n + per - 1) // per


def pack_codes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """``[..., n]`` u8 codes -> ``[..., packed_width(n, bits)]`` u8 wire bytes.

    For bits in {1, 2, 4, 8} exactly 8/bits codes share one byte (code i of a
    group occupies bits [i*bits, (i+1)*bits)); other widths ship one code per
    byte. :func:`unpack_codes` inverts it exactly."""
    if 8 % bits:
        return codes
    per = 8 // bits
    n = codes.shape[-1]
    pad = (-n) % per
    if pad:
        codes = torch.nn.functional.pad(codes, (0, pad))
    grouped = codes.reshape(*codes.shape[:-1], -1, per)
    packed = torch.zeros(grouped.shape[:-1], dtype=torch.uint8, device=codes.device)
    for i in range(per):
        packed |= grouped[..., i] << (i * bits)
    return packed


def unpack_codes(packed: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_codes`: ``[..., packed]`` u8 -> ``[..., n]`` u8."""
    if 8 % bits:
        return packed[..., :n]
    per = 8 // bits
    mask = (1 << bits) - 1
    parts = [(packed >> (i * bits)) & mask for i in range(per)]
    codes = torch.stack(parts, dim=-1).reshape(*packed.shape[:-1], -1)
    return codes[..., :n]
