"""Outer optimizers as terminal transforms over the pseudogradient (port of
``repro/optim/nesterov.py``).

:func:`nesterov` is the paper's Eq. (3):

    u^(t)     = mu * u^(t-H) + eta_out * Psi^(t)
    theta^(t) = theta^(t-1) - mu * u^(t) - eta_out * Psi^(t)

Both outer transforms are terminal: ``update`` passes Psi through and
``apply`` does the descent, in plain PyTorch or, with ``kernel=True``,
through the fused Hopper kernel (``kernels/ops.nesterov_update``, one
launch per leaf), which writes (theta', u') in one pass. The streaming
merge (``mask_state``) comes with streaming in a later slice (ROADMAP.md).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.optim.transform import Transform
from repro_torch.utils.tree import tree_map, tree_unzip

Tree = Any


def nesterov(lr: float, momentum: float, *, state_dtype=torch.float32,
             kernel: bool = False) -> Transform:
    """Outer SGD with Nesterov momentum; state ``{"u": tree}`` in
    ``state_dtype``; math in fp32 (or inside the fused kernel)."""

    def init(params: Tree) -> Tree:
        return {"u": tree_map(lambda p: torch.zeros(p.shape, dtype=state_dtype,
                                                    device=p.device), params)}

    def update(updates: Tree, state: Tree, params: Tree):
        return updates, state

    def apply(params: Tree, updates: Tree, state: Tree):
        if kernel:
            from repro_torch.kernels.ops import nesterov_update

            def upd(p, psi, u):
                p_new, u_new = nesterov_update(p, psi, u, lr=lr, momentum=momentum)
                return p_new, u_new.to(u.dtype)
        else:

            def upd(p, psi, u):
                psi = psi.float()
                u_new = momentum * u.float() + lr * psi
                p_new = p.float() - momentum * u_new - lr * psi
                return p_new.to(p.dtype), u_new.to(u.dtype)

        new_params, new_u = tree_unzip(tree_map(upd, params, updates, state["u"]), 2)
        return new_params, {"u": new_u}

    return Transform(init=init, update=update, apply=apply)


def outer_sgd(lr: float) -> Transform:
    """Plain outer SGD: theta' = theta - eta_out * Psi. Stateless."""

    def apply(params: Tree, updates: Tree, state: Tree):
        return tree_map(lambda p, psi: (p.float() - lr * psi.float()).to(p.dtype),
                        params, updates), state

    return Transform(init=lambda params: {}, update=lambda u, s, p: (u, s), apply=apply)
