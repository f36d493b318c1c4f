"""DiLoCo / MuLoCo on one card (port of ``repro/core/diloco.py``).

Algorithm 1 of the paper:

  * K workers each run H local steps of the **inner optimizer**
    (AdamW -> DiLoCo, Muon -> MuLoCo) on their own data shard;
  * every H steps the worker deltas Δ_k = θ_outer − θ_k are averaged into
    the pseudogradient Ψ;
  * the **outer** Nesterov-SGD applies Ψ to the outer params, which are then
    broadcast back to all workers.

Worker state is stacked on a leading K axis, as in the reference. Where the
reference vmaps the inner step over K, :func:`inner_step` loops over the K
workers in Python: the Hopper kernels on the path are launched through
ctypes and have no ``torch.func`` batching rule. Where JAX donates the
state, the port writes worker params, inner state and the outer state in
place (``copy_``), so a round holds one copy of each.

This slice ports the lockstep path with compression ``none`` (J = 1).
Compression, error feedback and streaming (Slice 3), elastic participation,
``sync_delay`` and the health sentinel (Slice 4), and the data-parallel
baseline (``dp_config`` / ``dp_step``) raise ``NotImplementedError`` naming
their slice of ROADMAP.md.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.optim import OptimizerConfig, make_inner_optimizer, make_outer_transform
from repro_torch.utils.tree import tree_leaves, tree_map

Tree = Any


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """The two fields of the reference's ``core/compression.CompressionConfig``
    this slice reads: only ``kind='none'`` without error feedback is ported
    (Slice 3 brings the codecs and their settings)."""
    kind: str = "none"  # none | topk | quant
    error_feedback: bool = False


@dataclasses.dataclass(frozen=True)
class DiLoCoConfig:
    n_workers: int = 8  # K
    sync_interval: int = 30  # H
    inner_name: str = "muon"  # 'muon' -> MuLoCo, 'adamw' -> DiLoCo
    outer_name: str = "nesterov"  # 'nesterov' (paper) | 'sgd'
    outer_lr: float = 0.7  # eta_out
    outer_momentum: float = 0.9  # mu
    compression: CompressionConfig = dataclasses.field(default_factory=CompressionConfig)
    streaming_partitions: int = 1  # J (1 = no streaming)
    ns_impl: str = "jnp"
    # route the outer descent through the fused Hopper outer-update kernel
    outer_kernel: bool = False
    outer_enabled: bool = True
    elastic: bool = False
    sync_delay: int = 0
    health_enabled: bool = False

    @property
    def is_muloco(self) -> bool:
        return self.inner_name == "muon"


def check_ported(dcfg: DiLoCoConfig) -> None:
    """Raise for the features of the reference this slice does not carry."""
    c = dcfg.compression
    slice3 = ("compression other than 'none'" if c.kind != "none" else
              "error feedback" if c.error_feedback else
              "streaming (J > 1)" if dcfg.streaming_partitions > 1 else None)
    if slice3:
        raise NotImplementedError(f"{slice3} is not ported to repro_torch yet: "
                                  "ROADMAP.md, Queue 1, Slice 3")
    slice4 = ("elastic participation" if dcfg.elastic else
              "sync_delay" if dcfg.sync_delay else
              "the health sentinel" if dcfg.health_enabled else None)
    if slice4:
        raise NotImplementedError(f"{slice4} is not ported to repro_torch yet: "
                                  "ROADMAP.md, Queue 1, Slice 4")
    if not dcfg.outer_enabled:
        raise NotImplementedError("the data-parallel baseline (outer_enabled=False, "
                                  "dp_config / dp_step) is not ported to repro_torch yet: "
                                  "ROADMAP.md, Queue 1, Slice 2 deferred items")


def make_optimizer(dcfg: DiLoCoConfig, inner_cfg: OptimizerConfig):
    kw = {"ns_impl": dcfg.ns_impl} if dcfg.inner_name != "adamw" else {}
    return make_inner_optimizer(dcfg.inner_name, inner_cfg, **kw)


class OuterOptimizer:
    """The pseudogradient path Δ -> reduce -> outer descent for compression
    ``none``: the reduce is the mean over K, the descent the terminal outer
    transform (Nesterov or SGD)."""

    def __init__(self, dcfg: DiLoCoConfig, state_dtype="float32"):
        check_ported(dcfg)
        self.dcfg = dcfg
        self.terminal = make_outer_transform(
            dcfg.outer_name, dcfg.outer_lr, dcfg.outer_momentum,
            state_dtype=state_dtype, kernel=dcfg.outer_kernel)

    def init_opt(self, params: Tree) -> Tree:
        return self.terminal.init(params)

    def reduce(self, deltas: Tree) -> Tree:
        """Ψ = mean over the K workers of the fp32 deltas."""
        return tree_map(lambda d: torch.mean(d.float(), dim=0), deltas)

    def descend(self, params: Tree, psi: Tree, opt_state: Tree):
        psi, opt_after = self.terminal.update(psi, opt_state, params)
        return self.terminal.apply(params, psi, opt_after)

    def step(self, params: Tree, deltas: Tree, opt_state: Tree):
        """(new_params, new_opt_state, psi)."""
        psi = self.reduce(deltas)
        new_params, new_opt = self.descend(params, psi, opt_state)
        return new_params, new_opt, psi


def make_outer(dcfg: DiLoCoConfig, state_dtype="float32") -> OuterOptimizer:
    return OuterOptimizer(dcfg, state_dtype=state_dtype)


def comm_bytes(params: Tree) -> int:
    """The reference's measured per-worker wire bytes of one sync for
    compression ``none``: an fp32 reduce-scatter plus all-gather, two full
    trees (``collectives._leaf_sync_bytes``)."""
    return int(sum(2 * p.numel() * 4 for p in tree_leaves(params)))


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------


def _stack(tree: Tree, K: int) -> Tree:
    return tree_map(lambda x: x.unsqueeze(0).repeat(K, *([1] * x.dim())), tree)


def diloco_init(model, dcfg: DiLoCoConfig, inner_cfg: OptimizerConfig,
                gen: torch.Generator, device) -> dict:
    """The TrainState (``repro_torch.engine.state``) of a fresh run."""
    from repro_torch.engine.state import train_state

    check_ported(dcfg)
    params = model.init(gen, device)
    K = dcfg.n_workers
    opt = make_optimizer(dcfg, inner_cfg)
    outer = make_outer(dcfg, state_dtype=inner_cfg.state_dtype)
    return train_state(
        outer_params=params,
        outer_opt=outer.init_opt(params),
        worker_params=_stack(params, K),
        # every worker's inner state starts equal, so one init stacked K
        # times is the reference's vmap(opt.init)
        inner_state=_stack(opt.init(params), K),
        round=torch.zeros((), dtype=torch.int32, device=device),
    )


# ---------------------------------------------------------------------------
# Inner step (every step; no cross-worker communication)
# ---------------------------------------------------------------------------


def _worker(tree: Tree, k: int) -> Tree:
    """Worker k's slice of a K-stacked tree (views into the stacked storage)."""
    return tree_map(lambda x: x[k], tree)


def _copy_into(dst: Tree, src: Tree) -> None:
    tree_map(lambda d, s: d.copy_(s), dst, src)


def inner_step(model, opt, state: dict, batch: dict) -> tuple[dict, dict]:
    """One local optimizer step on every worker. batch leaves: [K, B, ...].
    Worker params and inner state are updated in place."""
    K = batch["tokens"].shape[0]
    losses = []
    for k in range(K):
        params_k = _worker(state["worker_params"], k)
        inner_k = _worker(state["inner_state"], k)
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params_k)
        with torch.enable_grad():
            loss, _ = model.loss(leaves, {n: v[k] for n, v in batch.items()})
            flat = tree_leaves(leaves)
            grads_flat = torch.autograd.grad(loss, flat)
        it = iter(grads_flat)
        grads = tree_map(lambda _: next(it), leaves)
        new_p, new_s = opt.step(params_k, grads, inner_k)
        with torch.no_grad():
            _copy_into(params_k, new_p)
            _copy_into(inner_k, new_s)
        losses.append(loss.detach())
    losses = torch.stack(losses)
    return state, {"loss": torch.mean(losses), "loss_per_worker": losses}


# ---------------------------------------------------------------------------
# Outer step (the only cross-worker communication)
# ---------------------------------------------------------------------------


def compute_deltas(state: dict) -> Tree:
    """Δ_k = θ_outer − θ_k, stacked [K, ...] (paper Alg. 1 line 9)."""
    return tree_map(lambda o, w: o.float()[None] - w.float(),
                    state["outer_params"], state["worker_params"])


@torch.no_grad()
def outer_step(dcfg: DiLoCoConfig, state: dict, outer: OuterOptimizer | None = None
               ) -> tuple[dict, Tree]:
    """Communicate + outer update + worker reset. Returns (state, Ψ)."""
    outer = outer or make_outer(dcfg)
    new_outer, new_opt, psi = outer.step(state["outer_params"], compute_deltas(state),
                                         state["outer_opt"])
    _copy_into(state["outer_params"], new_outer)
    _copy_into(state["outer_opt"], new_opt)
    # broadcast the synced params back to every worker
    tree_map(lambda o, w: w.copy_(o[None].to(w.dtype).expand_as(w)),
             state["outer_params"], state["worker_params"])
    state["round"] = state["round"] + 1
    return state, psi


# ---------------------------------------------------------------------------
# A full round: H inner steps + sync
# ---------------------------------------------------------------------------


def diloco_round(model, dcfg: DiLoCoConfig, opt, state: dict, batches: dict,
                 outer: OuterOptimizer | None = None) -> tuple[dict, dict]:
    """One communication round: H inner steps then the outer sync.

    ``batches`` leaves: [H, K, B, ...]. Returns ``(state, {"loss": f32[H],
    "psi": tree, "comm_bytes": f32[], "active_workers": f32[],
    "staleness": f32[]})`` as the reference's J = 1 path.
    """
    H = dcfg.sync_interval
    if batches["tokens"].shape[0] != H:
        raise ValueError(f"batches hold {batches['tokens'].shape[0]} steps, H = {H}")
    device = state["round"].device
    comm = comm_bytes(state["outer_params"])
    losses = []
    for h in range(H):
        state, m = inner_step(model, opt, state, {n: v[h] for n, v in batches.items()})
        losses.append(m["loss"])
    state, psi = outer_step(dcfg, state, outer=outer)
    f32 = dict(dtype=torch.float32, device=device)
    return state, {"loss": torch.stack(losses), "psi": psi,
                   "comm_bytes": torch.tensor(float(comm), **f32),
                   "active_workers": torch.tensor(float(dcfg.n_workers), **f32),
                   "staleness": torch.tensor(float(dcfg.sync_delay), **f32)}
