"""GQA flash attention and paged decode attention (port of
``repro/kernels/flash_attention.py``).

Four Hopper kernels, written by hand in CUDA C++ (``csrc/``, built by
``_build.py``), replace the reference's Pallas kernels:

* ``flash_fwd`` replaces ``_fwd_kernel``: the forward, o and the per-row
  logsumexp, visiting only the kv tiles that the causal diagonal and the
  sliding window leave. bf16 inputs (every launch of the serving and
  training paths) take a tensor-core (``wgmma``) sweep over packed rows
  (the G query heads of a position are adjacent rows; tiles of
  ``FLASH_BWD_ROWS`` rows and ``FLASH_BWD_KEYS`` keys, walked as
  :func:`dq_kv_tiles` says) with an online softmax on the accumulator's
  rows; fp32 inputs take a CUDA-core sweep over the (positions, keys)
  tiles of ``FP32_TILES[hd]``, walked by the rule of
  :func:`visited_kv_range`.
  Each kernel is built for the head dims of ``KERNEL_HEAD_DIM`` (64, 80,
  112 and 128); a row of hd 128 is staged as two 64-column panels, and a
  row of hd 80 (zamba2's shared block) or 112 (kimi-k2) as two with the
  second zero-filled past column hd - 1 (only columns below hd are stored).
* ``flash_dq`` and ``flash_dkv`` (``csrc/flash_bwd.cu``) replace
  ``_dq_kernel`` and ``_dkv_kernel``: the backward's q-major and kv-major
  sweeps, recomputing the probabilities from the saved logsumexp. bf16
  inputs take tensor-core sweeps over packed rows with the forward's tiles,
  visited as :func:`dq_kv_tiles` and :func:`dkv_row_tiles` say; fp32 inputs
  take CUDA-core sweeps.
  :class:`FlashAttention` is the ``torch.autograd.Function`` around the
  forward and these two (the reference's custom VJP).
* ``paged_decode`` replaces ``_paged_kernel``: one new token per slot
  against the paged KV pool, read in its stored layout, in two passes of
  one launch: each block folds ``PAGED_SPLITS[hd]`` positions of one (slot,
  kv head) (split-K: :func:`paged_split_range`), then a combine pass merges
  the splits in a fixed order (:func:`_paged_decode_split_merge` mirrors
  both in fp32). It is built for the head dims of ``PAGED_SPLITS`` (64, 112
  and 128): the families with hd 80 serve through the dense-cache engine
  only.

Each wrapper takes the kernel's plain PyTorch version for a tensor that
lies on the CPU; for a CUDA tensor it launches the kernel or raises. Every
launch adds one to ``LAUNCHES[name]`` (shared with the other kernel
modules, ``_build.LAUNCHES``), so a run can show that its path went
through the kernels.

On a mesh (``kernels/partition.py``) both public wrappers run their
kernels on the rank's local block, as the reference's ``shard_map`` does:
the fused B·KV axis of flash attention (:func:`flash_specs`), the batch
slots and page-table rows of paged decode (:func:`paged_specs`).

The visit-schedule helpers are pure Python, carried over exactly.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import LAUNCHES, reset_launch_counts  # noqa: F401
from repro_torch.kernels.partition import active_partitioning, axes_entry, axes_for, shard_wrap

NEG_INF = -2.0e38
DEFAULT_BLOCK_Q = 512
DEFAULT_BLOCK_KV = 1024
# tile sizes of csrc/flash_fwd.cu's fp32 sweep (q positions, kv positions) at
# hd 64 and per head dim (a row takes one thread per 64-column panel, so hd
# 80 and 112 take hd 128's tiles; past G = 8 a block takes half the
# positions), and of the bf16 tensor-core sweeps of flash_fwd.cu and
# flash_bwd.cu (packed q rows, kv positions, at every head dim); checked
# against the built libraries at first launch
FLASH_BLOCK_Q = 32
FLASH_BLOCK_KV = 64
FP32_TILES = {64: (FLASH_BLOCK_Q, FLASH_BLOCK_KV), 80: (16, 32), 112: (16, 32), 128: (16, 32)}
FLASH_BWD_ROWS = 64
FLASH_BWD_KEYS = 64
# query heads per kv head the kernels take: the bf16 sweeps take any G
# (packed rows), the fp32 sweeps of flash_fwd and flash_dq run 32 threads per
# head up to G = 8 and 16 past it, in one block of at most 256 (mistral-large
# has G = 12), and paged_decode stages up to 16 query rows
MAX_GROUP = 16
# the head dims the flash libraries are built for: smollm-135m's 64, zamba2's
# 80, kimi-k2's 112 and 128 of every rung of the paper's ladder (paged_decode:
# PAGED_SPLITS)
KERNEL_HEAD_DIM = (64, 80, 112, 128)
# positions a block of csrc/paged_decode.cu's split-K pass folds (a multiple
# of the serving page size 16 and of the 32 lanes of its softmax step) per
# head dim: the same bytes of K and V a block at hd 64 and 128; checked
# against the built library
PAGED_SPLIT = 64
PAGED_SPLITS = {64: PAGED_SPLIT, 112: 32, 128: 32}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# The visit schedule: which (q-block, kv-block) pairs the grid executes.
# ---------------------------------------------------------------------------


def _block_visited(qi: int, kj: int, block_q: int, block_kv: int,
                   causal: bool, window: int) -> bool:
    """True when block (qi, kj) contains any unmasked (row, col) pair."""
    if causal and kj * block_kv > qi * block_q + block_q - 1:
        return False  # entirely above the diagonal
    if window and (qi * block_q) - (kj * block_kv + block_kv - 1) >= window:
        return False  # entirely left of the sliding window
    return True


def attention_schedule(nq: int, nkv: int, block_q: int, block_kv: int,
                       causal: bool, window: int,
                       skip: bool = True) -> list[tuple[int, int]]:
    """q-major list of visited (q-block, kv-block) pairs.

    ``skip=False`` returns the full nq x nkv sweep. For causal attention with
    ``block_q <= block_kv`` the visited count is at most ``nq*nkv/2 + nq``.
    """
    pairs = [(qi, kj) for qi in range(nq) for kj in range(nkv)
             if not skip or _block_visited(qi, kj, block_q, block_kv, causal, window)]
    if skip and causal and not window and block_q <= block_kv:
        assert len(pairs) <= nq * nkv // 2 + nq, (len(pairs), nq, nkv)
    return pairs


def visited_kv_range(qi: int, nkv: int, block_q: int, block_kv: int,
                     causal: bool, window: int) -> tuple[int, int]:
    """Contiguous [lo, hi) kv-block range q-block ``qi`` must visit."""
    visited = [kj for kj in range(nkv)
               if _block_visited(qi, kj, block_q, block_kv, causal, window)]
    assert visited, (qi, nkv, block_q, block_kv, causal, window)
    assert visited == list(range(visited[0], visited[-1] + 1)), "range not contiguous"
    return visited[0], visited[-1] + 1


def dq_kv_tiles(t: int, S: int, G: int, causal: bool, window: int,
                rows: int = FLASH_BWD_ROWS, keys: int = FLASH_BWD_KEYS) -> tuple[int, int]:
    """[lo, hi) of the kv tiles that the bf16 ``flash_dq`` block of packed
    q-row tile ``t`` walks (row r has position r // G): from the window's far
    edge of its first position to the causal diagonal of its last."""
    r0 = t * rows
    p_first, p_last = r0 // G, (min(r0 + rows, S * G) - 1) // G
    lo = max(0, p_first - window + 1) // keys if window else 0
    hi = p_last // keys + 1 if causal else -(-S // keys)
    return lo, hi


def dkv_row_tiles(kt: int, S: int, G: int, causal: bool, window: int,
                  rows: int = FLASH_BWD_ROWS, keys: int = FLASH_BWD_KEYS) -> tuple[int, int]:
    """[lo, hi) of the packed q-row tiles that the bf16 ``flash_dkv`` block
    of kv tile ``kt`` walks: the rows of the positions that see one of its
    keys, from the causal diagonal to the window's far edge."""
    k0, k1 = kt * keys, min(kt * keys + keys, S)
    p_lo = k0 if causal else 0
    p_hi = min(S, k1 - 1 + window) if window else S  # positions [p_lo, p_hi)
    return p_lo * G // rows, -(-p_hi * G // rows)


def clamp_block(block: int, S: int) -> int:
    """A divisor of S that is <= block, found by halving (1 for any S)."""
    b = max(1, min(block, S))
    while S % b:
        b //= 2
    return b


def visited_fraction(S: int, block_q: int, block_kv: int,
                     causal: bool, window: int) -> float:
    """Fraction of the nq x nkv block grid the schedule visits."""
    bq, bkv = clamp_block(block_q, S), clamp_block(block_kv, S)
    nq, nkv = S // bq, S // bkv
    return len(attention_schedule(nq, nkv, bq, bkv, causal, window)) / (nq * nkv)


# ---------------------------------------------------------------------------
# Kernel plumbing
# ---------------------------------------------------------------------------

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGTYPES = {
    "flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P],
    "flash_dq": [_P] * 7 + [_I] * 6 + [_F, _I, _P],
    "flash_dkv": [_P] * 8 + [_I] * 6 + [_F, _I, _P],
    "paged_decode": [_P] * 9 + [_I] * 7 + [_LL, _LL, _LL, _I, _F, _I, _P],
}
# the tile sizes each library's <lib>_tiles function must report (checked at
# its first launch): (the count of ints it reports, the leading ones).
# flash_fwd: the fp32 sweep's positions and keys at hd 64, the bf16 sweep's
# rows and keys, the fp32 sweep's positions and keys at hd 128, 80 and 112,
# then the bf16 block's dynamic shared memory in bytes at hd 64, 128, 80 and
# 112; flash_bwd: rows, keys, then the dq and dkv blocks' dynamic shared
# memory at hd 64, 128, 80 and 112; paged_decode: positions a split at hd 64,
# threads a split block, positions a split at hd 128 and at hd 112
_build.TILES.update({
    "flash_fwd": (14, (*FP32_TILES[64], FLASH_BWD_ROWS, FLASH_BWD_KEYS, *FP32_TILES[128],
                       *FP32_TILES[80], *FP32_TILES[112])),
    "flash_bwd": (10, (FLASH_BWD_ROWS, FLASH_BWD_KEYS)),
    "paged_decode": (4, (PAGED_SPLITS[64], 128, PAGED_SPLITS[128], PAGED_SPLITS[112]))})


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor of shape {tuple(t.shape)} is not contiguous")


def _launch(name: str, device: torch.device, *args) -> None:
    _build.launch(name, _ARGTYPES[name], device, *args)


def _check_aligned(name: str, *tensors: torch.Tensor) -> None:
    """The bf16 sweeps stage rows (128, 160, 224 or 256 bytes) with 16-byte
    copies."""
    if tensors[0].dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: bf16 inputs must start on a 16-byte boundary")


def _check_head(name: str, dtype: torch.dtype, hd: int, G: int) -> None:
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {dtype} (kernel takes float32 or bfloat16)")
    built = tuple(PAGED_SPLITS) if name == "paged_decode" else KERNEL_HEAD_DIM
    if hd not in built:
        raise NotImplementedError(
            f"{name}: head dim {hd} (the kernel is built for {built}); other head dims come "
            "with their model families (ROADMAP.md)")
    if not 1 <= G <= MAX_GROUP:
        raise NotImplementedError(f"{name}: {G} query heads per kv head (at most {MAX_GROUP})")


# ---------------------------------------------------------------------------
# Prefill: flash forward (q [BKV, S, G, hd]; k/v [BKV, S, hd])
# ---------------------------------------------------------------------------


def _fwd_plain(q, k, v, *, causal: bool, window: int, scale: float):
    """Plain version of ``flash_fwd``: fp32 math on the kernel layout.
    Returns (o in q's dtype, lse fp32 [BKV, S, G])."""
    s = torch.einsum("bqgh,bsh->bqgs", q.float(), k.float()) * scale
    mask = _mask(q.shape[1], causal, window, q.device)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    denom = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    o = torch.einsum("bqgs,bsh->bqgh", p, v.float()) / denom
    return o.to(q.dtype), (m + torch.log(denom))[..., 0]


def _fwd_cuda(q, k, v, *, causal: bool, window: int, scale: float):
    BKV, S, G, hd = q.shape
    _check_cuda("flash_fwd", q, k, v)
    _check_head("flash_fwd", q.dtype, hd, G)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_fwd: q {q.dtype}, k {k.dtype}, v {v.dtype}")
    if k.shape != (BKV, S, hd) or v.shape != k.shape or S < 1:
        raise ValueError(f"flash_fwd: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    _check_aligned("flash_fwd", q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((BKV, S, G), dtype=torch.float32, device=q.device)
    _launch("flash_fwd", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), BKV, S, G, hd, int(causal), int(window), scale,
            _DTYPE_CODE[q.dtype])
    return o, lse


def _fwd(q, k, v, *, causal: bool, window: int, scale: float):
    """(o, lse) of GQA attention in the kernel layout: the kernel on a CUDA
    tensor, its plain version on a CPU tensor."""
    if q.device.type == "cpu":
        return _fwd_plain(q, k, v, causal=causal, window=window, scale=scale)
    return _fwd_cuda(q, k, v, causal=causal, window=window, scale=scale)


def _mask(S: int, causal: bool, window: int, device) -> torch.Tensor:
    i = torch.arange(S, device=device)
    mask = torch.ones((S, S), dtype=torch.bool, device=device)
    if causal:
        mask &= i[:, None] >= i[None, :]
    if window:
        mask &= i[:, None] - i[None, :] < window
    return mask[None, :, None, :]


def _probs_plain(q, k, v, do, lse, dl, *, causal: bool, window: int, scale: float):
    """fp32 p (recomputed from the saved logsumexp, masked explicitly) and
    ds = p * (do v^T - dl), both [BKV, S, G, S]."""
    s = torch.einsum("bqgh,bsh->bqgs", q.float(), k.float()) * scale
    p = torch.where(_mask(q.shape[1], causal, window, q.device),
                    torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bqgh,bsh->bqgs", do.float(), v.float())
    return p, p * (dp - dl[..., None])


def _dq_plain(q, k, v, do, lse, dl, *, causal: bool, window: int, scale: float):
    """Plain version of ``flash_dq``: dq = scale * ds k."""
    _, ds = _probs_plain(q, k, v, do, lse, dl, causal=causal, window=window, scale=scale)
    return (scale * torch.einsum("bqgs,bsh->bqgh", ds, k.float())).to(q.dtype)


def _dkv_plain(q, k, v, do, lse, dl, *, causal: bool, window: int, scale: float):
    """Plain version of ``flash_dkv``: dk = scale * ds^T q and dv = p^T do,
    summed over the G query heads of each kv head."""
    p, ds = _probs_plain(q, k, v, do, lse, dl, causal=causal, window=window, scale=scale)
    dk = scale * torch.einsum("bqgs,bqgh->bsh", ds, q.float())
    dv = torch.einsum("bqgs,bqgh->bsh", p, do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _bwd_plain(q, k, v, do, lse, dl, *, causal: bool, window: int, scale: float):
    """Both plain versions (the CPU path): (dq, dk, dv)."""
    kw = dict(causal=causal, window=window, scale=scale)
    return (_dq_plain(q, k, v, do, lse, dl, **kw), *_dkv_plain(q, k, v, do, lse, dl, **kw))


def _check_bwd(q, k, v, do, lse, dl) -> None:
    BKV, S, G, hd = q.shape
    _check_cuda("flash_bwd", q, k, v, do, lse, dl)
    _check_head("flash_bwd", q.dtype, hd, G)
    if k.dtype != q.dtype or v.dtype != q.dtype or do.dtype != q.dtype:
        raise TypeError(f"flash_bwd: q {q.dtype}, k {k.dtype}, v {v.dtype}, do {do.dtype}")
    if lse.dtype != torch.float32 or dl.dtype != torch.float32:
        raise TypeError("flash_bwd: lse and dl must be float32")
    if (k.shape != (BKV, S, hd) or v.shape != k.shape or do.shape != q.shape
            or lse.shape != (BKV, S, G) or dl.shape != lse.shape):
        raise ValueError(f"flash_bwd: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"do {tuple(do.shape)}, lse {tuple(lse.shape)}")
    _check_aligned("flash_bwd", q, k, v, do)


def _bwd_args(q, k, v, do, lse, dl, causal, window, scale):
    BKV, S, G, hd = q.shape
    return ((q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
             dl.data_ptr()),
            (BKV, S, G, hd, int(causal), int(window), scale, _DTYPE_CODE[q.dtype]))


def _dq_cuda(q, k, v, do, lse, dl, *, causal: bool, window: int, scale: float):
    _check_bwd(q, k, v, do, lse, dl)
    dq = torch.empty_like(q)
    ptrs, tail = _bwd_args(q, k, v, do, lse, dl, causal, window, scale)
    _launch("flash_dq", q.device, *ptrs, dq.data_ptr(), *tail)
    return dq


def _dkv_cuda(q, k, v, do, lse, dl, *, causal: bool, window: int, scale: float):
    _check_bwd(q, k, v, do, lse, dl)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    ptrs, tail = _bwd_args(q, k, v, do, lse, dl, causal, window, scale)
    _launch("flash_dkv", q.device, *ptrs, dk.data_ptr(), dv.data_ptr(), *tail)
    return dk, dv


def _bwd_cuda(q, k, v, do, lse, dl, *, causal: bool, window: int, scale: float):
    kw = dict(causal=causal, window=window, scale=scale)
    return (_dq_cuda(q, k, v, do, lse, dl, **kw), *_dkv_cuda(q, k, v, do, lse, dl, **kw))


def _bwd(q, k, v, o, lse, do, *, causal: bool, window: int, scale: float):
    """(dq, dk, dv) in the kernel layout. ``dl = rowsum(do * o)`` in fp32 from
    the stored o, as the reference's ``_bwd``; then the two kernels on a CUDA
    tensor, their plain version on a CPU tensor."""
    dl = torch.sum(do.float() * o.float(), dim=-1)
    fn = _bwd_plain if q.device.type == "cpu" else _bwd_cuda
    return fn(q, k, v, do, lse, dl, causal=causal, window=window, scale=scale)


class FlashAttention(torch.autograd.Function):
    """GQA flash attention on the kernel layout (q [BKV, S, G, hd], k/v
    [BKV, S, hd]) with the flash backward: the reference's ``_flash_fn``
    custom VJP. The residuals are q, k, v, o and lse, all O(S)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, scale: float):
        o, lse = _fwd(q, k, v, causal=causal, window=window, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.cfg = (causal, window, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window, scale = ctx.cfg
        # autograd may hand in a strided gradient; the kernels take contiguous rows
        dq, dk, dv = _bwd(q, k, v, o, lse, do.contiguous(), causal=causal, window=window,
                          scale=scale)
        return dq, dk, dv, None, None, None


def gqa_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        block_q: int = DEFAULT_BLOCK_Q,
                        block_kv: int = DEFAULT_BLOCK_KV) -> torch.Tensor:
    """Fused GQA flash attention, differentiable (:class:`FlashAttention`).

    q ``[B, S, H, hd]``, k/v ``[B, S, KV, hd]`` -> ``[B, S, H, hd]``; query
    head h reads kv head h // G. Rows attend by absolute position;
    ``window`` is the sliding-window width (0 = none). ``block_q`` /
    ``block_kv`` shape the reference's TPU grid and are accepted so callers
    pass the config unchanged: the Hopper kernels choose their own tiles
    (bf16: ``FLASH_BWD_ROWS`` packed q rows x ``FLASH_BWD_KEYS`` keys on the
    tensor cores, forward and backward; fp32: ``FP32_TILES[hd]`` positions x
    keys in the forward) and the result does not depend on either.
    """
    del block_q, block_kv
    B, S, H, hd = q.shape
    KV = k.shape[2]
    assert H % KV == 0, (H, KV)
    G = H // KV
    qg = q.reshape(B, S, KV, G, hd).transpose(1, 2).reshape(B * KV, S, G, hd)
    kg = k.transpose(1, 2).reshape(B * KV, S, hd)
    vg = v.transpose(1, 2).reshape(B * KV, S, hd)
    cfg = (bool(causal), int(window), 1.0 / math.sqrt(hd))

    def fn(qb, kb, vb):
        return FlashAttention.apply(qb, kb, vb, *cfg)

    part = active_partitioning()
    if part is not None:
        # routed outside the autograd Function, so the dq / dkv sweeps run
        # on the same blocks as the forward
        q_spec, kv_spec = flash_specs(part, B * KV)
        fn = shard_wrap(fn, part, (q_spec, kv_spec, kv_spec), q_spec)
    o = _whole(fn(qg.contiguous(), kg.contiguous(), vg.contiguous()))
    return o.reshape(B, KV, S, G, hd).transpose(1, 2).reshape(B, S, H, hd)


def _whole(o):
    """A DTensor result replicated on every rank (the layout change back to
    the model layout splits the fused axis), a plain tensor as it is."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(o, DTensor):
        return o.redistribute(o.device_mesh, [Replicate()] * o.device_mesh.ndim)
    return o


def flash_specs(part, lead: int) -> tuple[tuple, tuple]:
    """(q spec [lead, S, G, hd], kv spec [lead, S, hd]) on a mesh: the fused
    B·KV axis (B-major) over ``part.flash_axes``; S whole on every rank. The
    specs serve the forward and both backward sweeps (dq as q, dk / dv as
    k / v, lse and dl as q's leading axis)."""
    a = axes_entry(axes_for(part, lead, part.flash_axes))
    return (a, None, None, None), (a, None, None)


def paged_specs(part, batch: int) -> tuple[tuple, tuple, tuple, tuple]:
    """(q, page_table, lengths, pool) specs of paged decode on a mesh: the
    batch slots shard q [B, KV, G, hd], the page table [B, max_pages] and
    lengths [B] together, so each rank looks up its own slots' rows, while
    the KV pool stays whole on every rank and any page id resolves there."""
    b = axes_entry(axes_for(part, batch, part.paged_axes))
    return (b, None, None, None), (b, None), (b,), (None, None, None, None)


# ---------------------------------------------------------------------------
# Paged decode attention (the serving hot path)
# ---------------------------------------------------------------------------
#
# The KV pool is a fixed set of fixed-size pages ([n_pages, page_size, KV,
# hd] per layer); a slot owns an ordered list of pages, given as a row of the
# int32 page table. Page 0 is the reserved null page: rows are 0-padded past
# a slot's allocation, and every position the mask rules out contributes
# exactly zero.


def _gather(q, k_pages, v_pages, page_table, lengths, window):
    B, KV, G, hd = q.shape
    ps = k_pages.shape[1]
    npages = page_table.shape[1]
    rows = page_table.long()
    kg = k_pages[rows].reshape(B, npages * ps, KV, hd)
    vg = v_pages[rows].reshape(B, npages * ps, KV, hd)
    s = torch.einsum("bkgh,bskh->bkgs", q.float(), kg.float()) / math.sqrt(hd)
    pos = torch.arange(npages * ps, device=q.device)[None, :]
    mask = pos < lengths[:, None]
    if window:
        mask &= pos > (lengths[:, None] - 1 - window)
    return s, mask[:, None, None, :], vg


def _paged_decode_xla(q, k_pages, v_pages, page_table, lengths, *, window):
    """Port of the reference's gather path (``impl='xla'``): probabilities
    are cast to q's dtype before the PV product, as there."""
    s, mask, vg = _gather(q, k_pages, v_pages, page_table, lengths, window)
    p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1).to(q.dtype)
    return torch.einsum("bkgs,bskh->bkgh", p, vg)


def _paged_decode_plain(q, k_pages, v_pages, page_table, lengths, *, window):
    """Plain version of ``paged_decode``: the gather formulation with the
    kernel's arithmetic (fp32 probabilities, explicit masking)."""
    s, mask, vg = _gather(q, k_pages, v_pages, page_table, lengths, window)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    denom = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    return (torch.einsum("bkgs,bskh->bkgh", p, vg.float()) / denom).to(q.dtype)


def paged_splits(table_w: int, page_size: int, split: int = PAGED_SPLIT) -> int:
    """Blocks per (slot, kv head) of the split-K pass: the positions the
    table can address, ``table_w * page_size``, in splits of ``split``."""
    return -(-table_w * page_size // split)


def paged_split_range(s: int, length: int, window: int, table_w: int, page_size: int,
                      split: int = PAGED_SPLIT) -> tuple[int, int]:
    """[p0, p1) of the positions split ``s`` of a slot of ``length`` folds:
    its ``split`` positions cut to the attended [lo, hi); empty (p0 >= p1)
    past the length, below the window, or past the table."""
    hi = min(length, table_w * page_size)
    lo = max(0, length - window) if window else 0
    return max(lo, s * split), min(hi, (s + 1) * split)


def _paged_decode_split_merge(q, k_pages, v_pages, page_table, lengths, *, window,
                              split: int = PAGED_SPLIT):
    """fp32 mirror of the kernel's schedule: each split of each slot folds
    its positions into (m, l, acc) (an empty split gives m = NEG_INF, l = 0,
    acc = 0), then the merge weighs the splits in order by exp(m_s - M) and
    divides by max(l, 1e-30). Not on any path: the tests hold it to
    :func:`_paged_decode_plain`."""
    B, KV, G, hd = q.shape
    ps, table_w = k_pages.shape[1], page_table.shape[1]
    scale = 1.0 / math.sqrt(hd)
    out = torch.empty((B, KV, G, hd), dtype=torch.float32)
    for b in range(B):
        ms, ls, accs = [], [], []
        for s in range(paged_splits(table_w, ps, split)):
            p0, p1 = paged_split_range(s, int(lengths[b]), window, table_w, ps, split)
            if p0 >= p1:
                ms.append(torch.full((KV, G), NEG_INF))
                ls.append(torch.zeros((KV, G)))
                accs.append(torch.zeros((KV, G, hd)))
                continue
            pos = torch.arange(p0, p1)
            pages = page_table[b, pos // ps].long()
            k, v = k_pages[pages, pos % ps].float(), v_pages[pages, pos % ps].float()
            sc = torch.einsum("kgh,nkh->kgn", q[b].float(), k) * scale
            m = sc.amax(dim=-1)
            p = torch.exp(sc - m[..., None])
            ms.append(m)
            ls.append(p.sum(dim=-1))
            accs.append(torch.einsum("kgn,nkh->kgh", p, v))
        M = torch.stack(ms).amax(dim=0)
        l, acc = torch.zeros((KV, G)), torch.zeros((KV, G, hd))
        for m, ls_, a in zip(ms, ls, accs):
            w = torch.exp(m - M)
            l = l + w * ls_
            acc = acc + w[..., None] * a
        out[b] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)


def _paged_decode_cuda(q, k_pages, v_pages, page_table, lengths, *, window):
    B, KV, G, hd = q.shape
    n_pages, ps = k_pages.shape[:2]
    _check_cuda("paged_decode", q, page_table, lengths)
    _check_head("paged_decode", q.dtype, hd, G)
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(f"paged_decode: q {q.dtype}, pool {k_pages.dtype}/{v_pages.dtype}")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("paged_decode: page_table and lengths must be int32")
    if (k_pages.shape != (n_pages, ps, KV, hd) or v_pages.shape != k_pages.shape
            or k_pages.stride() != v_pages.stride() or k_pages.stride(-1) != 1
            or page_table.shape[0] != B or lengths.shape != (B,)):
        raise ValueError(
            f"paged_decode: q {tuple(q.shape)}, pool {tuple(k_pages.shape)} strides "
            f"{k_pages.stride()}, table {tuple(page_table.shape)}, lengths {tuple(lengths.shape)}")
    for t in (k_pages, v_pages):
        if t.device != q.device:
            raise ValueError(f"paged_decode: pool on {t.device}, q on {q.device}")
    # K/V rows are read as 16-byte vectors
    vec = 16 // q.element_size()
    if (any(t.data_ptr() % 16 for t in (k_pages, v_pages))
            or any(st % vec for st in k_pages.stride()[:3])):
        raise ValueError(f"paged_decode: pool rows must start on 16-byte boundaries (strides "
                         f"{k_pages.stride()})")
    out = torch.empty_like(q)
    n_split = paged_splits(page_table.shape[1], ps, PAGED_SPLITS[hd])
    # the split-K pass's partials: acc [B, KV, n_split, G, hd], m and l [B, KV, n_split, G]
    acc = torch.empty((B, KV, n_split, G, hd), dtype=torch.float32, device=q.device)
    ml = torch.empty((2, B, KV, n_split, G), dtype=torch.float32, device=q.device)
    page_stride, pos_stride, head_stride, _ = k_pages.stride()
    _launch("paged_decode", q.device, q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(), acc.data_ptr(),
            ml[0].data_ptr(), ml[1].data_ptr(), B, KV, G, hd, ps, page_table.shape[1], n_pages,
            page_stride, pos_stride, head_stride, int(window), 1.0 / math.sqrt(hd),
            _DTYPE_CODE[q.dtype])
    return out


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                           page_table: torch.Tensor, lengths: torch.Tensor, *,
                           window: int = 0, impl: str = "xla") -> torch.Tensor:
    """One-token GQA attention against a paged KV cache.

    q ``[B, H, hd]`` (the new token per slot, RoPE applied); k/v pages
    ``[n_pool_pages, page_size, KV, hd]`` (one layer's pool, any strides
    with a contiguous head dim); ``page_table`` ``[B, max_pages]`` int32
    (0 = the null page); ``lengths`` ``[B]`` int32 including the current
    token. Returns ``[B, H, hd]``.

    ``impl='pallas'`` is the hand-written kernel (its plain version on CPU
    tensors); ``impl='xla'`` is the reference's gather path in plain torch.
    """
    B, H, hd = q.shape
    KV = k_pages.shape[2]
    assert H % KV == 0, (H, KV)
    qg = q.reshape(B, KV, H // KV, hd)
    if impl == "pallas":
        def local(qb, kp, vp, tbl, lens):
            if qb.device.type == "cpu":
                return _paged_decode_plain(qb, kp, vp, tbl, lens, window=window)
            return _paged_decode_cuda(qb.contiguous(), kp, vp, tbl, lens, window=window)

        part = active_partitioning()
        if part is not None:
            q_spec, tbl_spec, len_spec, pool_spec = paged_specs(part, B)
            local = shard_wrap(local, part, (q_spec, pool_spec, pool_spec, tbl_spec, len_spec),
                               q_spec)
        o = local(qg, k_pages, v_pages, page_table, lengths)
    elif impl == "xla":
        o = _paged_decode_xla(qg, k_pages, v_pages, page_table, lengths, window=window)
    else:
        raise ValueError(f"unknown impl {impl!r}")
    return o.reshape(B, H, hd)
