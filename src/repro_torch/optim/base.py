"""Minimal functional optimizer interface (port of ``repro/optim/base.py``).

An ``Optimizer`` is a pair of functions:

    state  = opt.init(params)
    params, state = opt.step(params, grads, state)

``state`` holds an int32 ``count`` tensor, so learning-rate schedules are
resolved on the device inside ``step`` (no host sync per step). All
optimizer math is fp32 regardless of the parameter dtype, and results are
cast back. :func:`descend` turns a direction-producing Transform chain into
a full descent step with the schedule, per-leaf lr scaling and decoupled
weight decay, evaluated with exactly the reference's association
``(p - lr*u) - lr*wd*p``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.utils.tree import tree_leaves

Tree = Any
Schedule = Callable[[torch.Tensor], torch.Tensor]  # step -> lr (absolute)


class Optimizer(NamedTuple):
    init: Callable[[Tree], Tree]
    step: Callable[[Tree, Tree, Tree], tuple[Tree, Tree]]


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Shared hyperparameters for inner optimizers."""

    lr: float = 1e-3
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.99
    eps: float = 1e-8
    # Muon-specific
    ns_iters: int = 5
    muon_lr_scale_mode: str = "paper"  # paper: sqrt(n/m) | jordan: sqrt(max(1,m/n)) | none
    # MuonBP (Khaled et al., 2025): orthogonalize every ns_period steps. 1 = plain Muon.
    ns_period: int = 1
    # schedule
    schedule: str = "constant"  # constant | cosine
    warmup_steps: int = 0
    total_steps: int = 1
    min_lr_ratio: float = 0.1
    # dtype of persistent optimizer state (momenta); math is always fp32
    state_dtype: str = "float32"


def constant_schedule(lr: float) -> Schedule:
    def sched(step):
        return torch.full((), lr, dtype=torch.float32, device=step.device)

    return sched


def cosine_schedule(lr: float, total_steps: int, warmup_steps: int = 0,
                    min_ratio: float = 0.1) -> Schedule:
    """Linear warmup followed by cosine decay to ``min_ratio * lr`` (paper: 0.1x)."""

    def sched(step):
        step = step.float()
        warm = float(max(warmup_steps, 1))
        total = float(max(total_steps, 1))
        warm_lr = lr * torch.clamp(step / warm, max=1.0)
        frac = torch.clamp((step - warm) / max(total - warm, 1.0), 0.0, 1.0)
        cos = min_ratio + (1.0 - min_ratio) * 0.5 * (1.0 + torch.cos(math.pi * frac))
        return torch.where(step < warmup_steps, warm_lr, lr * cos)

    return sched


def make_schedule(cfg: OptimizerConfig) -> Schedule:
    if cfg.schedule == "constant":
        return constant_schedule(cfg.lr)
    if cfg.schedule == "cosine":
        return cosine_schedule(cfg.lr, cfg.total_steps, cfg.warmup_steps, cfg.min_lr_ratio)
    raise ValueError(f"unknown schedule {cfg.schedule!r}")


def apply_update(param: torch.Tensor, update: torch.Tensor, lr, weight_decay) -> torch.Tensor:
    """Decoupled weight decay update: p <- p - lr*update - lr*wd*p (fp32 math)."""
    p32 = param.float()
    return (p32 - lr * update.float() - lr * weight_decay * p32).to(param.dtype)


# mults_fn(path, leaf) -> (update_lr_scale, decay_lr_scale): python floats
# multiplying the scheduled lr for the descent and the decay term of a leaf
MultsFn = Callable[[str, Any], tuple[float, float]]


def _descend_tree(params: Tree, u: Tree, lr, wd: float, mults_fn: MultsFn | None,
                  prefix: str = "") -> Tree:
    if isinstance(params, dict):
        return {k: _descend_tree(params[k], u[k], lr, wd, mults_fn,
                                 f"{prefix}/{k}" if prefix else str(k))
                for k in params}
    u_scale, d_scale = mults_fn(prefix, params) if mults_fn else (1.0, 1.0)
    um = lr * u_scale
    dm = (lr * d_scale) * wd
    p32 = params.float()
    return (p32 - um * u - dm * p32).to(params.dtype)


def descend(tx, cfg: OptimizerConfig, mults_fn: MultsFn | None = None,
            sched: Schedule | None = None) -> Optimizer:
    """Wrap a direction-producing Transform chain into a full Optimizer:

        p <- p - (lr * u_scale) * u - ((lr * d_scale) * wd) * p

    with exactly that association. State is ``{"tx": chain_state, "count":
    int32}``; lr comes from the schedule on the incremented count."""
    sched = sched or make_schedule(cfg)
    wd = cfg.weight_decay

    def init(params: Tree) -> Tree:
        device = tree_leaves(params)[0].device
        return {"tx": tx.init(params), "count": torch.zeros((), dtype=torch.int32,
                                                            device=device)}

    def step(params: Tree, grads: Tree, state: Tree):
        count = state["count"] + 1
        lr = sched(count)
        u, tx_state = tx.update(grads, state["tx"], params)
        return _descend_tree(params, u, lr, wd, mults_fn), {"tx": tx_state, "count": count}

    return Optimizer(init=init, step=step)
