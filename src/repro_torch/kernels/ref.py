"""Plain-torch oracles for the kernels (port of ``repro/kernels/ref.py``).

Dense fp32 formulations, independent of the kernels' tiling: the tests hold
the kernels' plain versions and the JAX oracles against these.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -2.0e38


def gqa_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0) -> torch.Tensor:
    """Dense fp32 GQA attention oracle for the flash kernel.

    q [B,S,H,hd], k/v [B,S,KV,hd] -> [B,S,H,hd]; rows attend by absolute
    position (training layout), ``window`` = sliding-window width (0=none).
    """
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, hd).float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) / math.sqrt(hd)
    i = torch.arange(S, device=q.device)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= i[:, None] >= i[None, :]
    if window:
        mask &= i[:, None] - i[None, :] < window
    s = torch.where(mask[None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v.float())
    return o.reshape(B, S, H, hd).to(q.dtype)


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                        page_table: torch.Tensor, lengths: torch.Tensor, *,
                        window: int = 0) -> torch.Tensor:
    """Dense fp32 oracle for the paged decode kernel.

    q [B,H,hd] (one new token per slot); k/v pages [P, ps, KV, hd];
    page_table [B, max_pages] int32; lengths [B] int32 include the current
    token. Gathers each slot's pages into a contiguous [len, KV, hd] view
    and runs plain masked GQA attention per slot.
    """
    B, H, hd = q.shape
    ps, KV = k_pages.shape[1], k_pages.shape[2]
    G = H // KV
    npages = page_table.shape[1]
    outs = []
    for b in range(B):
        rows = page_table[b].long()
        kg = k_pages[rows].reshape(npages * ps, KV, hd).float()
        vg = v_pages[rows].reshape(npages * ps, KV, hd).float()
        qb = q[b].reshape(KV, G, hd).float()
        s = torch.einsum("kgh,skh->kgs", qb, kg) / math.sqrt(hd)
        pos = torch.arange(npages * ps, device=q.device)
        mask = pos < lengths[b]
        if window:
            mask &= pos > lengths[b] - 1 - window
        s = torch.where(mask[None, None, :], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("kgs,skh->kgh", p, vg).reshape(H, hd))
    return torch.stack(outs).to(q.dtype)


def matmul_epilogue_ref(a, b, d=None, *, alpha=1.0, beta=0.0, out_dtype=None):
    out = alpha * (a.float() @ b.float())
    if d is not None and beta != 0.0:
        out = out + beta * d.float()
    return out.to(out_dtype or a.dtype)


def ns_iteration_ref(x: torch.Tensor) -> torch.Tensor:
    """One quintic Newton-Schulz iteration on [m, n] or a stack [z, m, n]."""
    from repro_torch.optim.muon import NS_COEFFS

    a, b, c = NS_COEFFS
    x32 = x.float()
    A = x32 @ x32.transpose(-1, -2)
    B = b * A + c * (A @ A)
    return (a * x32 + B @ x32).to(x.dtype)


def ns_orthogonalize_ref(g: torch.Tensor, iters: int = 5, eps: float = 1e-7) -> torch.Tensor:
    """Full NS orthogonalization oracle (fp32 throughout)."""
    m, n = g.shape[-2:]
    x = g.float()
    transpose = m > n
    if transpose:
        x = x.transpose(-1, -2)
    x = x / (torch.sqrt(torch.sum(x * x, dim=(-2, -1), keepdim=True)) + eps)
    for _ in range(iters):
        x = ns_iteration_ref(x)
    if transpose:
        x = x.transpose(-1, -2)
    return x.to(g.dtype)


def nesterov_update_ref(theta, psi, u, *, lr, momentum):
    psi32 = psi.float()
    u_new = momentum * u + lr * psi32
    theta_new = theta.float() - momentum * u_new - lr * psi32
    return theta_new.to(theta.dtype), u_new
