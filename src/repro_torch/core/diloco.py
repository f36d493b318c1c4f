"""DiLoCo / MuLoCo on one card (port of ``repro/core/diloco.py``).

Algorithm 1/2 of the paper:

  * K workers each run H local steps of the **inner optimizer**
    (AdamW -> DiLoCo, Muon -> MuLoCo) on their own data shard;
  * every H steps the worker deltas Δ_k = θ_outer − θ_k are (optionally
    EF-compressed and) averaged into the pseudogradient Ψ;
  * the **outer** Nesterov-SGD applies Ψ to the outer params, which are then
    broadcast back to all workers.

Worker state is stacked on a leading K axis, as in the reference. Where the
reference vmaps the inner step over K, :func:`inner_step` loops over the K
workers in Python: the Hopper kernels on the path are launched through
ctypes and have no ``torch.func`` batching rule. Where JAX donates the
state, the port writes worker params, inner state, the EF residuals and the
outer state in place (``copy_``), so a round holds one copy of each.

The pseudogradient path Δ -> compress/EF -> reduce -> outer descent is the
chain :func:`make_outer` declares (:class:`OuterOptimizer`), with the
compressors of :mod:`repro_torch.core.compression`, the wire packets of
:mod:`repro_torch.core.wire` and the collectives of
:mod:`repro_torch.core.collectives`; streaming (J > 1) syncs one partition
of :mod:`repro_torch.core.streaming` per segment. The health sentinel
(:mod:`repro_torch.core.health`) folds its running stats through the
state's ``health`` field. Elastic participation and ``sync_delay`` (Slice
4b) and the data-parallel baseline (``dp_config`` / ``dp_step``) raise
``NotImplementedError`` naming ROADMAP.md.

A round runs with no host read and no host-to-device copy, and writes
every state tensor in place (the round counter too), so the engine can
capture it in a CUDA graph: a captured round reads and writes fixed
addresses. The per-round constants (``comm_bytes``, ``active_workers``,
``staleness``) are built once (:func:`round_constants`) and handed to
every round.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.collectives import measured_sync_bytes, reduce_mean, segment_sync_update
from repro_torch.core.compression import CompressionConfig, compress, error_feedback
from repro_torch.core.health import HealthConfig, health_init, health_update
from repro_torch.core.streaming import masked_update, streaming_masks
from repro_torch.optim import (
    OptimizerConfig,
    chain,
    make_inner_optimizer,
    make_outer_transform,
)
from repro_torch.utils.tree import tree_leaves, tree_map

Tree = Any


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
    # the in-program health sentinel (core/health.py): per-round anomaly
    # flags; disabled adds no state field and no op
    health: HealthConfig = dataclasses.field(default_factory=HealthConfig)

    @property
    def is_muloco(self) -> bool:
        return self.inner_name == "muon"


def check_ported(dcfg: DiLoCoConfig) -> None:
    """Raise for the features of the reference the port does not carry yet."""
    slice4 = ("elastic participation" if dcfg.elastic else
              "sync_delay" if dcfg.sync_delay else None)
    if slice4:
        raise NotImplementedError(f"{slice4} is not ported to repro_torch yet: "
                                  "ROADMAP.md, Queue 1, Slice 4b")
    if not dcfg.outer_enabled:
        raise NotImplementedError("the data-parallel baseline (outer_enabled=False, "
                                  "dp_config / dp_step) is not ported to repro_torch yet: "
                                  "ROADMAP.md, Queue 1, Slice 2 deferred items")


def make_optimizer(dcfg: DiLoCoConfig, inner_cfg: OptimizerConfig):
    kw = {"ns_impl": dcfg.ns_impl} if dcfg.inner_name != "adamw" else {}
    return make_inner_optimizer(dcfg.inner_name, inner_cfg, **kw)


class OuterOptimizer:
    """The pseudogradient path Δ -> compress/EF -> reduce -> outer descent:
    the worker stage (``compress`` or ``error_feedback``) chained with
    ``reduce_mean`` (:meth:`reduce`), then the terminal outer transform
    (:meth:`descend`).

    The chain's state is the stage tuple ``(ef_residuals | (), ())``; the
    TrainState keeps the EF residuals and the outer-transform state in its
    ``ef`` / ``outer_opt`` fields, and this wrapper packs and unpacks them
    around the stages. ``step`` also owns the streaming-mask merges:
    candidate params and outer momentum merge under the partition mask, and
    untouched partitions keep their EF residuals.
    """

    def __init__(self, dcfg: DiLoCoConfig, state_dtype="float32"):
        check_ported(dcfg)
        ccfg = dcfg.compression
        self.dcfg = dcfg
        self.state_dtype = getattr(torch, str(state_dtype))
        self.has_ef = bool(ccfg.error_feedback and ccfg.kind != "none")
        self.has_wire = ccfg.kind != "none"
        self.worker_stage = error_feedback(ccfg) if self.has_ef else compress(ccfg)
        self.terminal = make_outer_transform(
            dcfg.outer_name, dcfg.outer_lr, dcfg.outer_momentum,
            state_dtype=state_dtype, kernel=dcfg.outer_kernel)

    def init_opt(self, params: Tree) -> Tree:
        return self.terminal.init(params)

    def init_ef(self, params: Tree, n_workers: int) -> Tree | None:
        """K-stacked EF residuals in ``state_dtype``, or None. They exist
        whenever ``error_feedback=True``, even with ``kind='none'``, where
        the chain skips the EF stage (the reference's allocation rule)."""
        if not self.dcfg.compression.error_feedback:
            return None
        template = tree_map(lambda p: torch.zeros((n_workers, *p.shape), dtype=self.state_dtype,
                                                  device=p.device), params)
        return error_feedback(self.dcfg.compression).init(template)

    def reduce(self, params: Tree, deltas: Tree, ef: Tree | None, mask: Tree | None = None):
        """The communication half of the sync: worker stage (compress / EF)
        and the pseudogradient all-reduce. Returns ``(psi, new_ef)``. A
        streaming segment (``mask``) with wire compression goes through
        ``segment_sync_update``, whose buffers shrink to the segment's rows."""
        ccfg = self.dcfg.compression
        if mask is not None and self.has_wire:
            psi, seg_ef = segment_sync_update(deltas, ef if self.has_ef else None, mask, ccfg)
            return psi, seg_ef if self.has_ef else ef
        sub = chain(self.worker_stage, reduce_mean(ccfg))
        psi, sub_state = sub.update(deltas, (ef if self.has_ef else (), ()), params)
        return psi, sub_state[0] if self.has_ef else ef

    def descend(self, params: Tree, psi: Tree, opt_state: Tree):
        """The terminal half: outer transform update + parameter descent.
        Returns ``(new_params, new_opt)``."""
        psi, opt_after = self.terminal.update(psi, opt_state, params)
        return self.terminal.apply(params, psi, opt_after)

    def step(self, params: Tree, deltas: Tree, opt_state: Tree, ef: Tree | None,
             mask: Tree | None = None):
        """:meth:`reduce` then :meth:`descend`, plus the streaming merges.
        Returns ``(new_params, new_opt_state, new_ef, psi)``."""
        psi, new_ef = self.reduce(params, deltas, ef, mask=mask)
        cand_params, new_opt = self.descend(params, psi, opt_state)
        if mask is None:
            return cand_params, new_opt, new_ef, psi
        new_params = masked_update(mask, cand_params, params)
        new_opt = self.terminal.mask_state(mask, new_opt, opt_state)
        if self.has_ef:  # untouched partitions keep their residuals
            new_ef = tree_map(lambda m, ne, oe: torch.where(_masked(m) > 0, ne, oe),
                              mask, new_ef, ef)
        return new_params, new_opt, new_ef, psi


def make_outer(dcfg: DiLoCoConfig, state_dtype="float32") -> OuterOptimizer:
    return OuterOptimizer(dcfg, state_dtype=state_dtype)


def comm_bytes(params: Tree, dcfg: DiLoCoConfig, masks: list[Tree] | None = None) -> int:
    """The round's measured per-worker wire bytes: one sync, or the J
    segment syncs of a streaming round, each its partition's share
    (``collectives.measured_sync_bytes``)."""
    def sync(mask=None) -> int:
        return measured_sync_bytes(params, dcfg.compression, dcfg.n_workers, mask=mask,
                                   outer_enabled=dcfg.outer_enabled)

    return sync() if not masks else sum(sync(m) for m in masks)


def make_streaming_masks(state: dict, dcfg: DiLoCoConfig) -> list[Tree] | None:
    if dcfg.streaming_partitions <= 1:
        return None
    return streaming_masks(state["outer_params"], dcfg.streaming_partitions)


def round_constants(state: dict, dcfg: DiLoCoConfig,
                    masks: list[Tree] | None = None) -> dict[str, torch.Tensor]:
    """The round's constant metrics as f32[] tensors on the state's device:
    ``comm_bytes`` (:func:`comm_bytes`, read off the host), the worker
    count and the sync delay. Built once per engine, before any capture."""
    J = dcfg.streaming_partitions
    comm = comm_bytes(state["outer_params"], dcfg, masks if J > 1 else None)
    device = state["round"].device

    def const(v: float) -> torch.Tensor:
        return torch.full((), float(v), dtype=torch.float32, device=device)

    return {"comm_bytes": const(comm), "active_workers": const(dcfg.n_workers),
            "staleness": const(dcfg.sync_delay)}


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
        ef=outer.init_ef(params, K),
        health=health_init(dcfg.health, device),
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


def _masked(m: torch.Tensor) -> torch.Tensor:
    """A mask leaf broadcast against a K-stacked leaf."""
    return m[None] if m.dim() else m


@torch.no_grad()
def outer_step(dcfg: DiLoCoConfig, state: dict, mask: Tree | None = None,
               outer: OuterOptimizer | None = None) -> tuple[dict, Tree]:
    """Communicate + outer update + worker reset, in place. Returns
    ``(state, Ψ)``. With a streaming partition ``mask`` only its share of
    the params syncs: the deltas are masked, the params, outer momentum and
    EF residuals merge under the mask, and only masked entries of the
    workers reset."""
    deltas = compute_deltas(state)
    if mask is not None:
        deltas = tree_map(lambda m, d: _masked(m) * d, mask, deltas)
    outer = outer or make_outer(dcfg)
    new_outer, new_opt, new_ef, psi = outer.step(
        state["outer_params"], deltas, state["outer_opt"], state.get("ef"), mask=mask)
    _copy_into(state["outer_params"], new_outer)
    _copy_into(state["outer_opt"], new_opt)
    if new_ef is not None:
        _copy_into(state["ef"], new_ef)

    # broadcast the synced params back to every worker (masked portions only)
    def reset(o, w, m=None):
        ob = o[None].to(w.dtype).expand_as(w)
        if m is None:
            w.copy_(ob)
        else:
            mm = _masked(m)
            w.copy_((mm * ob.float() + (1 - mm) * w.float()).to(w.dtype))

    if mask is None:
        tree_map(reset, state["outer_params"], state["worker_params"])
    else:
        tree_map(reset, state["outer_params"], state["worker_params"], mask)
    state["round"].add_(1)
    return state, psi


# ---------------------------------------------------------------------------
# A full round: H inner steps + sync(s)
# ---------------------------------------------------------------------------


def diloco_round(model, dcfg: DiLoCoConfig, opt, state: dict, batches: dict,
                 masks: list[Tree] | None = None,
                 outer: OuterOptimizer | None = None,
                 consts: dict[str, torch.Tensor] | None = None) -> tuple[dict, dict]:
    """One communication round: H inner steps then the outer sync(s).

    ``batches`` leaves: [H, K, B, ...]. With streaming (J > 1) the round is
    J segments of H/J steps, each followed by the partition-j sync
    (``masks`` from :func:`make_streaming_masks`). Returns ``(state,
    {"loss": f32[H], "psi": tree, "comm_bytes": f32[], "active_workers":
    f32[], "staleness": f32[]})`` as the reference does; with J > 1 each
    ``psi`` entry comes from the segment that synced it, and ``comm_bytes``
    sums the segments' measured wire bytes. ``consts`` is
    :func:`round_constants`' dict (built here when not given). With the
    health sentinel on, the state's ``health`` stats update in place and
    ``info["health"]`` is the round's flag bitmask.
    """
    H, J = dcfg.sync_interval, dcfg.streaming_partitions
    if batches["tokens"].shape[0] != H:
        raise ValueError(f"batches hold {batches['tokens'].shape[0]} steps, H = {H}")
    if J > 1 and H % J:
        raise ValueError("streaming requires the partition count to divide the sync "
                         f"interval: J={J} does not divide H={H}")
    if J > 1 and masks is None:
        raise ValueError("streaming (J>1) requires partition masks; build them with "
                         "make_streaming_masks(state, dcfg)")
    if consts is None:
        consts = round_constants(state, dcfg, masks)
    seg = H // max(J, 1)
    losses, psi = [], None
    for j in range(max(J, 1)):
        for h in range(j * seg, (j + 1) * seg):
            state, m = inner_step(model, opt, state, {n: v[h] for n, v in batches.items()})
            losses.append(m["loss"])
        if J <= 1:
            state, psi = outer_step(dcfg, state, outer=outer)
            continue
        state, psi_j = outer_step(dcfg, state, mask=masks[j], outer=outer)
        # psi leaves have no K axis: the masks broadcast directly
        masked_j = tree_map(lambda m, p: m * p, masks[j], psi_j)
        psi = masked_j if psi is None else tree_map(torch.add, psi, masked_j)
    losses = torch.stack(losses)
    info = {"loss": losses, "psi": psi, **consts}
    if "health" in state:
        with torch.no_grad():
            new_health, flag = health_update(dcfg.health, state["health"], losses, psi)
            _copy_into(state["health"], new_health)
        info["health"] = flag
    return state, info
