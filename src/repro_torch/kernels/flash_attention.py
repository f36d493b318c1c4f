"""GQA flash attention and paged decode attention (port of
``repro/kernels/flash_attention.py``).

Four Hopper kernels, written by hand in CUDA C++ (``csrc/``, built by
``_build.py``), replace the reference's Pallas kernels:

* ``flash_fwd`` replaces ``_fwd_kernel``: the forward, o and the per-row
  logsumexp, visiting only the kv tiles that the causal diagonal and the
  sliding window leave (the rule of :func:`visited_kv_range`, applied at
  the kernel's own tile sizes).
* ``flash_dq`` and ``flash_dkv`` (``csrc/flash_bwd.cu``) replace
  ``_dq_kernel`` and ``_dkv_kernel``: the backward's q-major and kv-major
  sweeps, recomputing the probabilities from the saved logsumexp.
  :class:`FlashAttention` is the ``torch.autograd.Function`` around the
  forward and these two (the reference's custom VJP).
* ``paged_decode`` replaces ``_paged_kernel``: one new token per slot
  against the paged KV pool, read in its stored layout.

Each wrapper takes the kernel's plain PyTorch version for a tensor that
lies on the CPU; for a CUDA tensor it launches the kernel or raises. Every
launch adds one to ``LAUNCHES[name]`` (shared with the other kernel
modules, ``_build.LAUNCHES``), so a run can show that its path went
through the kernels.

The visit-schedule helpers are pure Python, carried over exactly.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import LAUNCHES, reset_launch_counts  # noqa: F401

NEG_INF = -2.0e38
DEFAULT_BLOCK_Q = 512
DEFAULT_BLOCK_KV = 1024
# tile sizes of csrc/flash_fwd.cu (checked against the built library)
FLASH_BLOCK_Q = 32
FLASH_BLOCK_KV = 64
MAX_GROUP = {"flash_fwd": 256 // FLASH_BLOCK_Q, "paged_decode": 16, "flash_bwd": 8}
KERNEL_HEAD_DIM = 64  # the head dim of the configs ported so far
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
    "paged_decode": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                     _LL, _LL, _LL, _I, _F, _I, _P],
}
_TILES_CHECKED = []


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor of shape {tuple(t.shape)} is not contiguous")


def _launch(name: str, device: torch.device, *args) -> None:
    if name == "flash_fwd" and not _TILES_CHECKED:
        lib = _build.load("flash_fwd")
        bq, bkv = ctypes.c_int(), ctypes.c_int()
        lib.flash_fwd_tiles(ctypes.byref(bq), ctypes.byref(bkv))
        if (bq.value, bkv.value) != (FLASH_BLOCK_Q, FLASH_BLOCK_KV):
            raise RuntimeError(f"flash_fwd.cu tiles ({bq.value}, {bkv.value}) != "
                               f"({FLASH_BLOCK_Q}, {FLASH_BLOCK_KV}) in flash_attention.py")
        _TILES_CHECKED.append(True)
    _build.launch(name, _ARGTYPES[name], device, *args)


def _check_head(name: str, dtype: torch.dtype, hd: int, G: int) -> None:
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {dtype} (kernel takes float32 or bfloat16)")
    if hd != KERNEL_HEAD_DIM:
        raise NotImplementedError(f"{name}: head dim {hd} (kernel is built for {KERNEL_HEAD_DIM})")
    if not 1 <= G <= MAX_GROUP[name]:
        raise NotImplementedError(f"{name}: {G} query heads per kv head (at most {MAX_GROUP[name]})")


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
    pass the config unchanged: the Hopper kernel tiles with
    ``FLASH_BLOCK_Q`` x ``FLASH_BLOCK_KV`` and the result does not depend on
    either.
    """
    del block_q, block_kv
    B, S, H, hd = q.shape
    KV = k.shape[2]
    assert H % KV == 0, (H, KV)
    G = H // KV
    qg = q.reshape(B, S, KV, G, hd).transpose(1, 2).reshape(B * KV, S, G, hd)
    kg = k.transpose(1, 2).reshape(B * KV, S, hd)
    vg = v.transpose(1, 2).reshape(B * KV, S, hd)
    o = FlashAttention.apply(qg.contiguous(), kg.contiguous(), vg.contiguous(), bool(causal),
                             int(window), 1.0 / math.sqrt(hd))
    return o.reshape(B, KV, S, G, hd).transpose(1, 2).reshape(B, S, H, hd)


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
    out = torch.empty_like(q)
    page_stride, pos_stride, head_stride, _ = k_pages.stride()
    _launch("paged_decode", q.device, q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(), B, KV, G, hd, ps,
            page_table.shape[1], n_pages, page_stride, pos_stride, head_stride, int(window),
            1.0 / math.sqrt(hd), _DTYPE_CODE[q.dtype])
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
        if q.device.type == "cpu":
            o = _paged_decode_plain(qg, k_pages, v_pages, page_table, lengths, window=window)
        else:
            o = _paged_decode_cuda(qg.contiguous(), k_pages, v_pages, page_table, lengths,
                                   window=window)
    elif impl == "xla":
        o = _paged_decode_xla(qg, k_pages, v_pages, page_table, lengths, window=window)
    else:
        raise ValueError(f"unknown impl {impl!r}")
    return o.reshape(B, H, hd)
