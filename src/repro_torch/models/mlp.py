"""Dense feed-forward block (port of ``init_mlp`` / ``mlp`` in
``repro/models/mlp.py``). The MoE layer comes with a later slice (ROADMAP.md).
"""
from __future__ import annotations

from typing import Any

import torch

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
    dt = cfg.compute_dtype
    h = x @ p["w_in"].to(dt)
    if cfg.activation == "swiglu":
        h = activation_fn("swiglu", h, x @ p["w_gate"].to(dt))
    else:
        h = activation_fn(cfg.activation, h)
    return h @ p["w_out"].to(dt)
