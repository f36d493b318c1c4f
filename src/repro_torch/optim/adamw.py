"""AdamW (port of ``repro/optim/adamw.py``): the paper's DiLoCo inner
optimizer, and the fallback group inside Muon's ``partition``.

:func:`scale_by_adam` produces the bias-corrected Adam direction and
:func:`repro_torch.optim.base.descend` applies it with the schedule and
decoupled weight decay. Paper setting: b1=0.9, b2=0.99.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.optim.base import Optimizer, OptimizerConfig, descend
from repro_torch.optim.transform import Transform, _zero_count
from repro_torch.utils.tree import tree_map, tree_unzip

Tree = Any


def scale_by_adam(cfg: OptimizerConfig) -> Transform:
    """u = (m / bc1) / (sqrt(v / bc2) + eps), moments stored in state_dtype."""
    b1, b2, eps = cfg.b1, cfg.b2, cfg.eps
    sdt = getattr(torch, cfg.state_dtype)

    def init(tree: Tree) -> Tree:
        def zeros(p):
            return torch.zeros(p.shape, dtype=sdt, device=p.device)

        return {"m": tree_map(zeros, tree), "v": tree_map(zeros, tree),
                "count": _zero_count(tree)}

    def update(updates: Tree, state: Tree, params: Tree):
        count = state["count"] + 1
        bc1 = 1.0 - torch.pow(b1, count.float())
        bc2 = 1.0 - torch.pow(b2, count.float())

        def upd(g, m, v):
            g = g.float()
            m = b1 * m.float() + (1.0 - b1) * g
            v = b2 * v.float() + (1.0 - b2) * g * g
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            return u, m.to(sdt), v.to(sdt)

        u, new_m, new_v = tree_unzip(tree_map(upd, updates, state["m"], state["v"]), 3)
        return u, {"m": new_m, "v": new_v, "count": count}

    return Transform(init=init, update=update)


def adamw(cfg: OptimizerConfig) -> Optimizer:
    return descend(scale_by_adam(cfg), cfg)
