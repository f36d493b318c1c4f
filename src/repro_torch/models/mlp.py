"""Feed-forward blocks (port of ``repro/models/mlp.py``): the dense FFN
(SwiGLU / squared-ReLU / GELU) and the DeepSeekMoE-style mixture of experts
(shared + fine-grained routed experts).

The MoE keeps the reference's grouped capacity dispatch: tokens are split
into G groups, each (token, slot) pair is scattered into an [E·C, d] buffer
per group, the experts run as batched matmuls over [G, E, C, d], and the
outputs are gathered back and summed under the renormalised gates. Every op
is a pure function of its inputs, so a captured round replays bitwise: the
scatter writes unique destinations only (an indexed copy; dropped pairs
land in their own spill rows past E·C, which are cut off, where the
reference drops out-of-bounds writes), and the only sums a backward makes
over repeated indices are the gather's, whose repeats (slot 0 for dropped
pairs) add zeros.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core.collectives import copy_in, reduce_out
from repro_torch.models.common import ModelConfig, activation_fn, dense_init

Tree = Any


def init_mlp(gen: torch.Generator, cfg: ModelConfig, device, n_layers: int | None = None,
             d_ff: int | None = None) -> Tree:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    L = (n_layers,) if n_layers else ()
    pd = cfg.pdtype
    params = {
        "w_in": dense_init(gen, (*L, d, ff), fan_in=d, dtype=pd, device=device),
        "w_out": dense_init(gen, (*L, ff, d), fan_in=ff, dtype=pd, device=device),
    }
    if cfg.activation == "swiglu":
        params["w_gate"] = dense_init(gen, (*L, d, ff), fan_in=d, dtype=pd, device=device)
    return params


def mlp(p: Tree, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The dense FFN; under tensor parallelism (``core/collectives.py``)
    on the rank's columns of ``w_in`` / ``w_gate`` and rows of ``w_out``, the
    partial outputs summed over 'model'."""
    dt = cfg.compute_dtype
    x = copy_in(x)
    h = x @ p["w_in"].to(dt)
    if cfg.activation == "swiglu":
        h = activation_fn("swiglu", h, x @ p["w_gate"].to(dt))
    else:
        h = activation_fn(cfg.activation, h)
    return reduce_out(h @ p["w_out"].to(dt))


# ---------------------------------------------------------------------------
# Mixture of Experts (DeepSeekMoE-style: shared + fine-grained routed experts)
# ---------------------------------------------------------------------------


def init_moe(gen: torch.Generator, cfg: ModelConfig, device,
             n_layers: int | None = None) -> Tree:
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    L = (n_layers,) if n_layers else ()
    pd = cfg.pdtype
    params = {
        "router": dense_init(gen, (*L, d, E), fan_in=d, dtype=pd, device=device),
        # routed experts: banked weights [*, E, d, ff]
        "experts": {
            "w_in": dense_init(gen, (*L, E, d, ff), fan_in=d, dtype=pd, device=device),
            "w_gate": dense_init(gen, (*L, E, d, ff), fan_in=d, dtype=pd, device=device),
            "w_out": dense_init(gen, (*L, E, ff, d), fan_in=ff, dtype=pd, device=device),
        },
    }
    if cfg.n_shared_experts:
        shared_ff = ff * cfg.n_shared_experts
        params["shared"] = {
            "w_in": dense_init(gen, (*L, d, shared_ff), fan_in=d, dtype=pd, device=device),
            "w_gate": dense_init(gen, (*L, d, shared_ff), fan_in=d, dtype=pd, device=device),
            "w_out": dense_init(gen, (*L, shared_ff, d), fan_in=shared_ff, dtype=pd,
                                device=device),
        }
    return params


def _expert_ffn(w: Tree, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Per-expert SwiGLU on dispatched tokens. x: [G, E, C, d]; weights [E, d, ff]."""
    dt = cfg.compute_dtype
    h = torch.einsum("gecd,edf->gecf", x, w["w_in"].to(dt))
    g = torch.einsum("gecd,edf->gecf", x, w["w_gate"].to(dt))
    h = activation_fn("swiglu", h, g)
    return torch.einsum("gecf,efd->gecd", h, w["w_out"].to(dt))


def _n_groups(cfg: ModelConfig, T: int) -> int:
    """Largest group count <= cfg.moe_groups that divides T (>=1)."""
    g = max(cfg.moe_groups, 1)
    while g > 1 and (T % g or T // g < cfg.experts_per_token):
        g -= 1
    return g


def moe(p: Tree, cfg: ModelConfig, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """MoE layer. x: [B, S, d] -> (out [B, S, d], aux load-balance loss).

    Capacity is per token group, so a token's output depends on what the
    other tokens of its group route (at decode, the other slots of a step)."""
    B, S, d = x.shape
    T = B * S
    E, k = cfg.n_experts, cfg.experts_per_token
    dt = cfg.compute_dtype
    G = _n_groups(cfg, T)
    t = T // G
    xg = x.reshape(G, t, d)

    logits = (xg @ p["router"].to(dt)).float()  # [G, t, E]
    gates = torch.softmax(logits, dim=-1)
    top_vals, top_idx = torch.topk(gates, k, dim=-1)  # [G, t, k], sorted as lax.top_k
    # normalize selected gate weights (DeepSeekMoE)
    top_vals = top_vals / torch.sum(top_vals, dim=-1, keepdim=True)

    # ---- per-group capacity dispatch ----
    C = max(int(t * k / E * cfg.capacity_factor), 4)
    flat_e = top_idx.reshape(G, t * k)  # expert id per (token, slot)
    pos = torch.cumsum(F.one_hot(flat_e, E), dim=1) - 1  # running per-expert rank
    my_pos = torch.gather(pos, 2, flat_e[..., None])[..., 0]  # [G, t*k]
    keep = my_pos < C
    # a dropped pair writes its own spill row past E*C (cut off below): every
    # destination is unique, as the reference's out-of-bounds drop
    spill = E * C + torch.arange(t * k, device=x.device)[None, :]
    dest = torch.where(keep, flat_e * C + torch.clamp(my_pos, 0, C - 1), spill)

    x_rep = xg[:, :, None, :].expand(G, t, k, d).reshape(G, t * k, d)  # jnp.repeat
    gidx = torch.arange(G, device=x.device)[:, None].expand(G, t * k)
    buf = xg.new_zeros((G, E * C + t * k, d)).index_put((gidx, dest), x_rep)
    dispatched = buf[:, :E * C].reshape(G, E, C, d)

    y = _expert_ffn(p["experts"], cfg, dispatched)  # [G, E, C, d]

    # ---- combine ----
    y_flat = y.reshape(G, E * C, d)
    gather_dest = torch.where(keep, dest, 0)  # dropped rows read slot 0, zeroed by w
    gathered = y_flat[gidx, gather_dest]  # [G, t*k, d]
    w = (top_vals.reshape(G, t * k) * keep.float()).to(dt)
    out = torch.sum((gathered * w[..., None]).reshape(G, t, k, d), dim=2)

    # shared experts are always-on dense FFNs
    if "shared" in p:
        shared_cfg = cfg.replace(activation="swiglu")
        out = out + mlp(p["shared"], shared_cfg, xg.reshape(T, d)).reshape(G, t, d)

    # Switch-style load balance aux: E * sum_e f_e * p_e (global)
    frac_tokens = torch.mean(F.one_hot(top_idx, E).float(), dim=(0, 1, 2)) * k
    mean_gate = torch.mean(gates, dim=(0, 1))
    aux = E * torch.sum(frac_tokens * mean_gate)
    return out.reshape(B, S, d), aux
