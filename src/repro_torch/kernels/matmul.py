"""Batched matmul with a fused axpy epilogue — the Newton–Schulz hot spot
(port of ``repro/kernels/matmul.py``).

    C = alpha * (A @ B) + beta * D

One hand-written Hopper kernel (``csrc/matmul_epilogue.cu``) replaces the
reference's ``_matmul_epilogue_kernel``. Where the reference vmaps its
2-D call over a stacked ``[L, m, n]`` leaf, the kernel takes the batch
dimension itself, so one launch covers every layer of a leaf. Operands are
read through their strides: a transposed operand is a view, not a copy.
Full fp32 arithmetic, no TF32, as the reference's fp32 Newton–Schulz mode.

The wrapper takes the kernel's plain PyTorch version for a tensor that lies
on the CPU; for a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I] + [_LL] * 9 + [_F, _F, _I, _I, _P]
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _matmul_plain(a, b, d, *, alpha: float, beta: float, out_dtype):
    """Plain version of ``matmul_epilogue``: fp32 product, then the epilogue
    in the reference's order (``alpha * acc``, then ``+ beta * d``)."""
    out = alpha * torch.matmul(a.float(), b.float())
    if d is not None and beta != 0.0:
        out = out + beta * d.float()
    return out.to(out_dtype)


def _matmul_cuda(a, b, d, *, alpha: float, beta: float, out_dtype):
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
                  *dd.stride(), alpha, beta, int(use_d), _DTYPE_CODE[a.dtype])
    return c


def matmul_epilogue(a: torch.Tensor, b: torch.Tensor, d: torch.Tensor | None = None, *,
                    alpha: float = 1.0, beta: float = 0.0,
                    out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """C = alpha * (a @ b) + beta * d for ``[m, k] @ [k, n]`` or stacked
    ``[z, m, k] @ [z, k, n]`` operands of any strides (no padding: the
    kernel masks ragged edges). ``d=None`` or ``beta=0`` never reads d."""
    out_dtype = out_dtype or a.dtype
    if a.device.type == "cpu":
        return _matmul_plain(a, b, d, alpha=alpha, beta=beta, out_dtype=out_dtype)
    squeeze = a.dim() == 2
    if squeeze:
        a, b = a[None], b[None]
        d = None if d is None else d[None]
    c = _matmul_cuda(a, b, d, alpha=float(alpha), beta=float(beta), out_dtype=out_dtype)
    return c[0] if squeeze else c
