"""Muon variants as small deltas on the transform chain (port of
``repro/optim/muon_variants.py``).

* ``muon_bp``: block-periodic Muon (MuonBP, Khaled et al., 2025):
  orthogonalize every ``cfg.ns_period`` steps, plain momentum-SGD between.
  At period 1 this *is* Muon (the periodic stage is bypassed).

* ``normuon``: neuron-wise second-moment normalization (NorMuon, Li et al.,
  2025): after Newton–Schulz, each output neuron (row of the [..., m, n]
  update) is rescaled by its running RMS, then the per-matrix norm is
  restored so Muon's shape-scaled lr transfer still applies.

Both keep every step's branch on the device: the periodic cadence is a
``torch.where`` on a device-side ``do_ns`` flag, and NorMuon's bias
correction a ``torch.pow`` of the device counter, so a round captured in a
CUDA graph replays the right branch at every step. The select runs the
Newton–Schulz iterations on every step, as the reference's ``lax.cond``
does under ``vmap`` (both branches execute).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.optim.base import Optimizer, OptimizerConfig, descend
from repro_torch.optim.muon import (
    muon_mults,
    muon_partition,
    ns_fn_for,
    orthogonalize,
    trace_momentum,
)
from repro_torch.optim.transform import Transform, _zero_count, chain
from repro_torch.utils.tree import tree_map, tree_map_with_path, tree_unzip

Tree = Any


def orthogonalize_periodic(cfg: OptimizerConfig, ns_impl: str = "jnp") -> Transform:
    """NS every ``cfg.ns_period`` steps (steps 1, 1 + b, 1 + 2b, ... of an
    own counter); the fp32 momentum passes through between."""
    if cfg.ns_period <= 1:
        return orthogonalize(cfg, ns_impl)
    ns_fn = ns_fn_for(ns_impl)
    iters, period = cfg.ns_iters, cfg.ns_period

    def init(tree: Tree) -> Tree:
        return {"count": _zero_count(tree)}

    def update(updates: Tree, state: Tree, params: Tree):
        from repro_torch.core.collectives import on_whole

        count = state["count"] + 1
        do_ns = torch.remainder(count - 1, period) == 0

        def per_leaf(path, m):  # a leaf split over 'model' orthogonalized whole
            return torch.where(do_ns, on_whole(path, m, lambda w: ns_fn(w, iters=iters).float()),
                               m.float())

        return tree_map_with_path(per_leaf, updates), {"count": count}

    return Transform(init=init, update=update)


def muon_bp(cfg: OptimizerConfig, ns_impl: str = "jnp",
            adamw_lr_ratio: float = 1.0) -> Optimizer:
    """Block-periodic Muon: ``cfg.ns_period`` sets the NS cadence."""
    tx = muon_partition(cfg, chain(trace_momentum(cfg),
                                   orthogonalize_periodic(cfg, ns_impl)))
    return descend(tx, cfg, muon_mults(cfg, adamw_lr_ratio))


def scale_by_neuron_rms(cfg: OptimizerConfig) -> Transform:
    """NorMuon post-scaling: divide each output neuron (row) by its running
    second-moment RMS, then restore the per-matrix Frobenius norm.

    State is one ``[..., m, 1]`` buffer per hidden matrix in
    ``cfg.state_dtype`` plus an int32 ``count``."""
    b2, eps = cfg.b2, cfg.eps
    sdt = getattr(torch, cfg.state_dtype)

    def init(tree: Tree) -> Tree:
        return {"v": tree_map(lambda p: torch.zeros((*p.shape[:-1], 1), dtype=sdt,
                                                    device=p.device), tree),
                "count": _zero_count(tree)}

    def update(updates: Tree, state: Tree, params: Tree):
        count = state["count"] + 1
        bc2 = 1.0 - torch.pow(b2, count.float())

        def upd(u, v):
            u = u.float()
            v = b2 * v.float() + (1.0 - b2) * torch.mean(u * u, dim=-1, keepdim=True)
            vhat = v / bc2
            un = u / (torch.sqrt(vhat) + eps)
            # restore the per-matrix norm so the orthogonalized scale survives
            norm_u = torch.sqrt(torch.sum(u * u, dim=(-2, -1), keepdim=True))
            norm_un = torch.sqrt(torch.sum(un * un, dim=(-2, -1), keepdim=True))
            return un * (norm_u / (norm_un + eps)), v.to(sdt)

        u, new_v = tree_unzip(tree_map(upd, updates, state["v"]), 2)
        return u, {"v": new_v, "count": count}

    return Transform(init=init, update=update)


def normuon(cfg: OptimizerConfig, ns_impl: str = "jnp",
            adamw_lr_ratio: float = 1.0) -> Optimizer:
    """NorMuon: Muon + neuron-wise RMS post-scaling after Newton–Schulz."""
    tx = muon_partition(cfg, chain(trace_momentum(cfg),
                                   orthogonalize(cfg, ns_impl),
                                   scale_by_neuron_rms(cfg)))
    return descend(tx, cfg, muon_mults(cfg, adamw_lr_ratio))
