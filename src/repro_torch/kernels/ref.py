"""Plain-torch oracles for the attention kernels (port of ``repro/kernels/ref.py``).

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
