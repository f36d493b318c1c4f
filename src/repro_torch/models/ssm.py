"""Mamba2 (state-space duality / SSD) block (port of ``repro/models/ssm.py``),
arXiv:2405.21060.

The chunked SSD: quadratic attention-like products inside chunks of length
Q plus a linear recurrence over the chunk states; decode is the O(1)
recurrent update on a [B, H, P, N] state. The reference has no kernel here
(plain ``jnp`` and one ``lax.scan``), so neither has the port.

Where the reference writes a three-operand einsum, the port writes the pair
of batched products its shapes allow, so no [B, Cc, H, Q, Q, P] operand is
ever formed. The inter-chunk ``lax.scan`` is a Python loop over the S / Q
chunks (static, so a captured round replays it), and every ``cumsum`` runs
along one axis of a multi-dimensional tensor, never over a flattened one.

Layout notes
  d_inner = expand * d_model, P = ssm_head_dim, H = d_inner / P heads,
  N = ssm_state, single B/C group (G=1) as in mamba2-370m.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig, dense_init, rms_norm

Tree = Any


def init_mamba(gen: torch.Generator, cfg: ModelConfig, device,
               n_layers: int | None = None) -> Tree:
    d, di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_ch = di + 2 * N  # conv over (x, B, C)
    d_in_proj = 2 * di + 2 * N + H  # z, x, B, C, dt
    L = (n_layers,) if n_layers else ()
    pd = cfg.pdtype
    conv_w = torch.randn((*L, cfg.conv_width, conv_ch), generator=gen, device=device) * 0.1
    a_log = torch.log(torch.linspace(1.0, 16.0, H, device=device)).expand(*L, H)
    return {
        "in_proj": dense_init(gen, (*L, d, d_in_proj), fan_in=d, dtype=pd, device=device),
        "conv_w": conv_w.to(pd),
        "conv_bias": torch.zeros((*L, conv_ch), dtype=pd, device=device),
        "a_log": a_log.to(pd).contiguous(),
        "dt_bias": torch.zeros((*L, H), dtype=pd, device=device),
        "d_skip": torch.ones((*L, H), dtype=pd, device=device),
        "gate_norm_scale": torch.zeros((*L, di), dtype=pd, device=device),
        "out_proj": dense_init(gen, (*L, di, d), fan_in=di, dtype=pd, device=device),
    }


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x [..., Q] -> [..., Q, Q]; out[i, j] = sum_{j < k <= i} x[k], -inf for
    j > i. The mask is a ``where``, so the gradient at masked entries is 0."""
    Q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    return torch.where(mask, diff, -torch.inf)


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. xBC [B,S,C]; w [W,C]; b [C]."""
    W = w.shape[0]
    S = xBC.shape[1]
    pad = F.pad(xBC, (0, 0, W - 1, 0))
    out = torch.zeros(xBC.shape, dtype=torch.float32, device=xBC.device)
    for i in range(W):  # W is tiny (4): unrolled taps
        out = out + pad[:, i:i + S, :].float() * w[i].float()
    return F.silu(out + b.float()).to(xBC.dtype)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) (torch's softplus switches to the
    identity above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _split_proj(p: Tree, cfg: ModelConfig, x: torch.Tensor):
    di, N = cfg.d_inner, cfg.ssm_state
    zxbcdt = x @ p["in_proj"].to(x.dtype)
    z, xBC, dt = torch.split(zxbcdt, [di, di + 2 * N, zxbcdt.shape[-1] - 2 * di - 2 * N],
                             dim=-1)
    return z, xBC, dt  # dt: [B, S, H]


def _ssd(cfg: ModelConfig, xs: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
         Bm: torch.Tensor, Cm: torch.Tensor) -> torch.Tensor:
    """The chunked SSD scan: xs [B,S,H*P], dt [B,S,H] fp32, A [H], Bm and Cm
    [B,S,N] -> Y [B,Cc,Q,H,P] fp32 (before the D skip)."""
    B, S, _ = xs.shape
    N, H, P, Q = cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_chunk
    Cc = S // Q
    dA = dt * A  # [B,S,H]

    # chunk views
    xc = xs.reshape(B, Cc, Q, H, P).float()
    Bc = Bm.reshape(B, Cc, Q, N).float()
    Cm_c = Cm.reshape(B, Cc, Q, N).float()
    dA_c = dA.reshape(B, Cc, Q, H)
    dt_c = dt.reshape(B, Cc, Q, H)
    dAcum = torch.cumsum(dA_c, dim=2)  # [B,Cc,Q,H]

    # --- intra-chunk (diagonal blocks) ---
    Lmat = torch.exp(_segsum(dA_c.transpose(2, 3)))  # [B,Cc,H,Q,Q]
    CB = Cm_c @ Bc.transpose(-1, -2)  # [B,Cc,Q,Q]
    M = CB[:, :, None] * Lmat  # [B,Cc,H,i,j]
    u = (dt_c[..., None] * xc).permute(0, 1, 3, 2, 4)  # [B,Cc,H,j,P]
    Y_diag = (M @ u).permute(0, 1, 3, 2, 4)  # [B,Cc,i,H,P]

    # --- chunk states ---
    decay_states = torch.exp(dAcum[:, :, -1:, :] - dAcum)  # [B,Cc,Q,H]
    wx = ((decay_states * dt_c)[..., None] * xc).permute(0, 1, 3, 4, 2)  # [B,Cc,H,P,j]
    S_chunk = wx @ Bc[:, :, None]  # [B,Cc,H,P,N]

    # --- inter-chunk recurrence (linear scan over chunk states) ---
    chunk_decay = torch.exp(dAcum[:, :, -1, :])  # [B,Cc,H]
    h = torch.zeros((B, H, P, N), dtype=torch.float32, device=xs.device)
    h_in = []  # the state entering each chunk
    for c in range(Cc):
        h_in.append(h)
        h = chunk_decay[:, c, :, None, None] * h + S_chunk[:, c]
    h_in = torch.stack(h_in, dim=1)  # [B,Cc,H,P,N]

    state_decay = torch.exp(dAcum)  # [B,Cc,Q,H]
    Y_off = (Cm_c[:, :, None] @ h_in.transpose(-1, -2))  # [B,Cc,H,i,P]
    Y_off = Y_off.permute(0, 1, 3, 2, 4) * state_decay[..., None]  # [B,Cc,i,H,P]
    return Y_diag + Y_off


def mamba_forward(p: Tree, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence chunked SSD. x: [B, S, d] with S % chunk == 0."""
    B, S, _ = x.shape
    di, N, H, P, Q = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_chunk
    assert S % Q == 0, f"seq {S} must be divisible by ssm_chunk {Q}"
    dt_compute = cfg.compute_dtype

    z, xBC, dt = _split_proj(p, cfg, x)
    xBC = _causal_conv(xBC, p["conv_w"], p["conv_bias"])
    xs, Bm, Cm = torch.split(xBC, [di, N, N], dim=-1)  # [B,S,di],[B,S,N],[B,S,N]

    dt = _softplus(dt.float() + p["dt_bias"].float())  # [B,S,H]
    A = -torch.exp(p["a_log"].float())  # [H]

    Y = _ssd(cfg, xs, dt, A, Bm, Cm).reshape(B, S, H, P)
    x_heads = xs.reshape(B, S, H, P).float()
    Y = (Y + p["d_skip"].float()[None, None, :, None] * x_heads).reshape(B, S, di)

    # gated RMSNorm + out projection
    Y = rms_norm((Y * F.silu(z.float())).to(dt_compute), p["gate_norm_scale"])
    return Y @ p["out_proj"].to(dt_compute)


def init_ssm_state(cfg: ModelConfig, batch: int, n_layers: int, device) -> Tree:
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    conv_ch = cfg.d_inner + 2 * N
    return {
        "h": torch.zeros((n_layers, batch, H, P, N), dtype=torch.float32, device=device),
        "conv": torch.zeros((n_layers, batch, cfg.conv_width - 1, conv_ch),
                            dtype=cfg.compute_dtype, device=device),
    }


def mamba_decode(p: Tree, cfg: ModelConfig, x: torch.Tensor,
                 state: Tree) -> tuple[torch.Tensor, Tree]:
    """One-token recurrent update. x: [B, 1, d]; state: {"h", "conv"} (one
    layer's, written in place and returned)."""
    B = x.shape[0]
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    dtc = cfg.compute_dtype

    z, xBC_new, dt = _split_proj(p, cfg, x)  # xBC_new [B,1,C]
    # rolling conv buffer: [B, W-1, C] previous inputs
    buf = torch.cat([state["conv"], xBC_new.to(state["conv"].dtype)], dim=1)  # [B,W,C]
    w = p["conv_w"].float()  # [W, C]
    conv_out = torch.sum(buf.float() * w[None], dim=1, keepdim=True)  # [B,1,C]
    xBC = F.silu(conv_out + p["conv_bias"].float()).to(dtc)

    xs, Bm, Cm = torch.split(xBC, [di, N, N], dim=-1)
    dt = _softplus(dt[:, 0].float() + p["dt_bias"].float())  # [B,H]
    A = -torch.exp(p["a_log"].float())
    g = torch.exp(dt * A)  # [B,H]

    xh = xs[:, 0].reshape(B, H, P).float()
    Bv = Bm[:, 0].float()  # [B,N]
    Cv = Cm[:, 0].float()
    h = (state["h"] * g[..., None, None]
         + (dt[..., None] * xh)[..., None] * Bv[:, None, None, :])  # [B,H,P,N]
    y = (h @ Cv[:, None, :, None])[..., 0] + p["d_skip"].float()[:, None] * xh
    y = y.reshape(B, 1, di)

    y = rms_norm((y * F.silu(z.float())).to(dtc), p["gate_norm_scale"])
    out = y @ p["out_proj"].to(dtc)
    state["h"].copy_(h)
    state["conv"].copy_(buf[:, 1:, :])
    return out, state
