"""Fused Nesterov outer update (paper Eq. 3; port of
``repro/kernels/outer_update.py``).

    u'     = mu * u + eta * psi
    theta' = theta - mu * u' - eta * psi

One elementwise pass producing both outputs. The hand-written Hopper kernel
``nesterov`` (``csrc/outer_update.cu``) replaces the reference's
``_nesterov_kernel``; it rounds every product and sum on its own, in the
order of :func:`_nesterov_plain`, so on the card the two are bitwise equal.

The wrapper takes the plain PyTorch version for a tensor that lies on the
CPU; for a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGTYPES = [_P, _P, _P, _P, _P, _LL, _F, _F, _I, _I, _P]
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def outer_update_spec(part, shape: tuple[int, ...]) -> tuple:
    """Shape-preserving spec of one outer-update operand on a mesh: the
    outer-state ZeRO layout of ``launch/sharding.param_spec(outer=True)``,
    dim -2 over ('pod', 'data') (else 'data', else whole) and dim -1 over
    'model' when ``part.outer_tp``; vectors and scalars whole. The update is
    elementwise, so the local block is flattened inside the mapped region."""
    sizes = part.axis_sizes()
    nd = len(shape)
    if nd <= 1:
        return (None,) * nd

    def div(dim: int, k: int) -> bool:
        return k > 0 and dim % k == 0 and dim >= k

    pod, data = sizes.get("pod", 0), sizes.get("data", 0)
    spec: list = [None] * nd
    if pod and div(shape[-2], pod * data):
        spec[-2] = ("pod", "data")
    elif div(shape[-2], data):
        spec[-2] = "data"
    if part.outer_tp and div(shape[-1], sizes.get("model", 0)):
        spec[-1] = "model"
    return tuple(spec)


def _nesterov_plain(theta, psi, u, *, lr: float, momentum: float):
    """Plain version of ``nesterov``: fp32 math, theta' cast back to theta's
    dtype, u' fp32."""
    psi = psi.float()
    u_new = momentum * u.float() + lr * psi
    theta_new = theta.float() - momentum * u_new - lr * psi
    return theta_new.to(theta.dtype), u_new


def _nesterov_cuda(theta, psi, u, *, lr: float, momentum: float):
    if theta.dtype not in _DTYPE_CODE:
        raise TypeError(f"nesterov: theta dtype {theta.dtype} (kernel takes float32 or bfloat16)")
    if psi.dtype != torch.float32 or u.dtype != torch.float32:
        raise TypeError(f"nesterov: psi {psi.dtype} and u {u.dtype} must be float32")
    (n,) = theta.shape
    for t in (psi, u):
        if t.shape != (n,) or t.device != theta.device:
            raise ValueError(f"nesterov: theta {tuple(theta.shape)} on {theta.device}, "
                             f"got {tuple(t.shape)} on {t.device}")
    if not (theta.is_contiguous() and psi.is_contiguous() and u.is_contiguous()):
        raise ValueError("nesterov: operands must be contiguous")
    theta_out = torch.empty_like(theta)
    u_out = torch.empty_like(u)
    ptrs = (theta.data_ptr(), psi.data_ptr(), u.data_ptr(), theta_out.data_ptr(),
            u_out.data_ptr())
    vec4 = theta.dtype == torch.float32 and all(p % 16 == 0 for p in ptrs)
    _build.launch("nesterov", _ARGTYPES, theta.device, *ptrs, n, lr, momentum,
                  _DTYPE_CODE[theta.dtype], int(vec4))
    return theta_out, u_out


def fused_nesterov_update(theta: torch.Tensor, psi: torch.Tensor, u: torch.Tensor, *,
                          lr: float, momentum: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Flat ``[n]`` arrays -> ``(theta', u')``. No padding: the kernel handles
    any n."""
    fn = _nesterov_plain if theta.device.type == "cpu" else _nesterov_cuda
    return fn(theta, psi, u, lr=float(lr), momentum=float(momentum))
