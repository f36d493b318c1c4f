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

On a mesh of ranks (``TrainEngine(mesh=...)``) the same functions run on
each rank's compute layout: the rank's own workers ([K/pod, ...] worker
trees, each whole) and its rows of their batches, with the outer state as
DTensors in its ZeRO layout. The hooks of :mod:`repro_torch.core.collectives`
do the exchanges (gradients averaged over 'data', losses and wire packets
gathered across 'pod', θ_outer gathered whole for Δ and the reset), and
are the identity in one process. Every variant runs there: an elastic
round reads the rank's workers' entries of the replicated [K] mask
(``local_workers``) and averages over the global one; a streaming segment
merges the outer state on each rank's block; the sync delay's FIFO holds
each slot in the outer layout; the DP config gathers its K = 1 worker's
params into the outer layout. On a tensor-parallel round each rank holds its
block of the workers' split matrices and the sync runs on them gathered
whole over 'model' (:func:`outer_step`).

The pseudogradient path Δ -> compress/EF -> reduce -> outer descent is the
chain :func:`make_outer` declares (:class:`OuterOptimizer`), with the
compressors of :mod:`repro_torch.core.compression`, the wire packets of
:mod:`repro_torch.core.wire` and the collectives of
:mod:`repro_torch.core.collectives`; streaming (J > 1) syncs one partition
of :mod:`repro_torch.core.streaming` per segment. The health sentinel
(:mod:`repro_torch.core.health`) folds its running stats through the
state's ``health`` field.

Elastic execution (``elastic=True``) carries a [K] participation mask in the
state: a dropped worker (mask 0) is frozen for the round with
``torch.where``, so its params, inner state and EF residual come back
bit-identical, and the pseudogradient mean runs over the survivors. Where
the reference branches on the device (``lax.cond``: the literal dense
program when everyone takes part, the masked one otherwise), the port's
caller picks the program on the host, from a mask it made there
(``diloco_round(masked=)``), so a captured round reads nothing back.
``sync_delay = d`` applies Ψ from d rounds back, through the state's
``pending`` FIFO. ``dp_config`` is the data-parallel baseline, the
degenerate K = 1, H = 1 round with no outer optimizer.

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

from repro_torch.core.collectives import (
    block,
    data_mean,
    from_block,
    gather_model,
    gather_workers,
    like,
    local,
    local_workers,
    measured_sync_bytes,
    model_group,
    participation_mean,
    reduce_mean,
    segment_sync_update,
    split_model,
    whole,
)
from repro_torch.core.compression import CompressionConfig, compress, error_feedback
from repro_torch.core.health import HealthConfig, health_init, health_update
from repro_torch.core.streaming import masked_update, streaming_masks
from repro_torch.optim import (
    OptimizerConfig,
    chain,
    make_inner_optimizer,
    make_outer_transform,
)
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unzip

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


def dp_config(inner_name: str, ns_impl: str = "jnp") -> DiLoCoConfig:
    """The DP baseline as a degenerate DiLoCo config (K=1, H=1, no outer)."""
    return DiLoCoConfig(n_workers=1, sync_interval=1, inner_name=inner_name,
                        outer_lr=1.0, outer_momentum=0.0, outer_enabled=False,
                        ns_impl=ns_impl)


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

    def reduce(self, params: Tree, deltas: Tree, ef: Tree | None, mask: Tree | None = None,
               participation: torch.Tensor | None = None, delta=None):
        """The communication half of the sync: worker stage (compress / EF)
        and the pseudogradient all-reduce. Returns ``(psi, new_ef)``. A
        streaming segment (``mask``) multiplies Δ by its mask; with wire
        compression it goes through ``segment_sync_update``, whose buffers
        shrink to the segment's rows.

        The stages run one leaf at a time (every stage is leafwise, so this
        is the whole-tree chain's arithmetic). ``delta(o, x)``, when given,
        makes a leaf's [K, ...] Δ from its outer leaf and its ``deltas``
        leaf: ``outer_step`` passes the worker params, so only one leaf's Δ
        is ever alive.

        A ``participation`` mask ([K] fp32 {0, 1}) restricts the mean to the
        surviving workers and freezes the dropped workers' EF residuals:
        their packets were never sent, so the residuals come back
        bit-identical (a select, not an EF decay)."""
        ccfg = self.dcfg.compression
        sub = chain(self.worker_stage, reduce_mean(ccfg, participation))
        holes = tree_map(lambda _: None, params)

        def per_leaf(o, x, e, m):
            d = delta(o, x) if delta is not None else x
            if m is not None:
                d = _masked(m) * d
            if m is not None and self.has_wire:
                psi, new_e = segment_sync_update(d, e, m, ccfg, participation=participation)
            else:
                psi, (new_e, _) = sub.update(d, (e if self.has_ef else (), ()), o)
            if participation is not None and self.has_ef:
                keep = local_workers(participation.float()) > 0  # the rank's workers
                new_e = torch.where(keep.reshape((keep.shape[0],) + (1,) * (new_e.dim() - 1)),
                                    new_e, e.to(new_e.dtype))
            return psi, new_e

        psi, new_ef = tree_unzip(tree_map(per_leaf, params, deltas,
                                          ef if self.has_ef else holes,
                                          holes if mask is None else mask), 2)
        return psi, (new_ef if self.has_ef else ef)

    def descend(self, params: Tree, psi: Tree, opt_state: Tree):
        """The terminal half: outer transform update + parameter descent.
        Returns ``(new_params, new_opt)``."""
        psi = tree_map(like, params, psi)  # on a mesh: in the outer state's layout
        psi, opt_after = self.terminal.update(psi, opt_state, params)
        return self.terminal.apply(params, psi, opt_after)

    def step(self, params: Tree, deltas: Tree, opt_state: Tree, ef: Tree | None,
             mask: Tree | None = None, participation: torch.Tensor | None = None,
             delta=None):
        """:meth:`reduce` then :meth:`descend`, plus the streaming merges.
        Returns ``(new_params, new_opt_state, new_ef, psi)``."""
        psi, new_ef = self.reduce(params, deltas, ef, mask=mask, participation=participation,
                                  delta=delta)
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
    count and the sync delay. Built once per engine, before any capture. An
    elastic round scales the first two by its participation mask on the
    device (:func:`diloco_round`)."""
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

    if dcfg.sync_delay:
        if not dcfg.outer_enabled:
            raise ValueError("sync_delay requires the outer optimizer "
                             "(outer_enabled=False has no pseudogradient to delay)")
        if dcfg.streaming_partitions > 1:
            raise ValueError("sync_delay cannot be combined with streaming "
                             "(J>1) segment syncs")
    params = model.init(gen, device)
    K = dcfg.n_workers
    opt = make_optimizer(dcfg, inner_cfg)
    outer = make_outer(dcfg, state_dtype=inner_cfg.state_dtype)
    # the pending FIFO starts as zeros: the first sync_delay rounds apply a
    # zero pseudogradient (the outer params hold still while it fills)
    pending = (tree_map(lambda p: torch.zeros((dcfg.sync_delay, *p.shape), dtype=torch.float32,
                                              device=p.device), params)
               if dcfg.sync_delay else None)
    return train_state(
        outer_params=params,
        outer_opt=outer.init_opt(params),
        worker_params=_stack(params, K),
        # every worker's inner state starts equal, so one init stacked K
        # times is the reference's vmap(opt.init)
        inner_state=_stack(opt.init(params), K),
        round=torch.zeros((), dtype=torch.int32, device=device),
        ef=outer.init_ef(params, K),
        participation=(torch.ones((K,), dtype=torch.float32, device=device)
                       if dcfg.elastic else None),
        pending=pending,
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


def _grads(loss: torch.Tensor, leaves: Tree) -> Tree:
    """d loss / d leaves, as a tree shaped like ``leaves``."""
    it = iter(torch.autograd.grad(loss, tree_leaves(leaves)))
    return tree_map(lambda _: next(it), leaves)


def inner_step(model, opt, state: dict, batch: dict,
               participation: torch.Tensor | None = None) -> tuple[dict, dict]:
    """One local optimizer step on every worker. batch leaves: [K, B, ...].
    Worker params and inner state are updated in place.

    A ``participation`` mask ([K] fp32 {0, 1}) freezes the dropped workers:
    each worker's new params and inner state are selected with
    ``torch.where``, so a dropped worker's come back bit-identical, and the
    reported loss is the mean over the survivors. The loss is the
    reference's sum·(1/K) (``collectives.participation_mean``), which is
    what ``jnp.mean`` computes."""
    K = batch["tokens"].shape[0]
    # on a mesh the rank's own workers' entries of the global [K] mask
    mine = None if participation is None else local_workers(participation)
    losses = []
    for k in range(K):
        params_k = _worker(state["worker_params"], k)
        inner_k = _worker(state["inner_state"], k)
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params_k)
        with torch.enable_grad():
            loss, _ = model.loss(leaves, {n: v[k] for n, v in batch.items()})
        # the gradient tree is handed over without a name here, so the step
        # frees it once its directions are computed; on a mesh it is first
        # averaged over the ranks that split the batch ('data')
        new_p, new_s = opt.step(params_k, tree_map(data_mean, _grads(loss, leaves)), inner_k)
        with torch.no_grad():
            if participation is None:
                _copy_into(params_k, new_p)
                _copy_into(inner_k, new_s)
            else:
                keep = mine[k] > 0
                for dst, src in ((params_k, new_p), (inner_k, new_s)):
                    tree_map(lambda d, s: d.copy_(torch.where(keep, s, d)), dst, src)
        # copied in: freed before the next worker's step allocates its own
        del new_p, new_s
        losses.append(data_mean(loss.detach()))
    losses = gather_workers(torch.stack(losses))  # on a mesh: every worker's, across 'pod'
    return state, {"loss": participation_mean(losses, participation),
                   "loss_per_worker": losses}


# ---------------------------------------------------------------------------
# Outer step (the only cross-worker communication)
# ---------------------------------------------------------------------------


def _delta(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One leaf's Δ_k = θ_outer − θ_k, stacked [K, ...] (paper Alg. 1 line 9);
    on a mesh θ_outer is gathered whole from its ZeRO layout first."""
    return whole(o).float()[None] - w.float()


def compute_deltas(state: dict) -> Tree:
    """Δ_k = θ_outer − θ_k, stacked [K, ...] (paper Alg. 1 line 9)."""
    return tree_map(_delta, state["outer_params"], state["worker_params"])


def _masked(m: torch.Tensor) -> torch.Tensor:
    """A mask leaf broadcast against a K-stacked leaf."""
    return m[None] if m.dim() else m


_FROM_STATE = object()  # outer_step reads the participation mask off the state


def _shift_in(fifo: torch.Tensor, new: torch.Tensor) -> None:
    """Shift a [d, ...] FIFO one slot toward 0 and write ``new`` into its
    tail, in place: slot by slot from the front (each copy reads the slot
    behind the one it writes, so no two views overlap) and no allocation."""
    for i in range(fifo.shape[0] - 1):
        fifo[i].copy_(fifo[i + 1])
    fifo[-1].copy_(new.to(fifo.dtype))


@torch.no_grad()
def outer_step(dcfg: DiLoCoConfig, state: dict, mask: Tree | None = None,
               outer: OuterOptimizer | None = None,
               participation: torch.Tensor | None = _FROM_STATE) -> tuple[dict, Tree]:
    """Communicate + outer update + worker reset, in place. Returns
    ``(state, Ψ)``.

    With a streaming partition ``mask`` only its share of the params syncs:
    the deltas are masked, the params, outer momentum and EF residuals merge
    under the mask, and only masked entries of the workers reset.

    ``participation`` defaults to the state's mask (pass ``None`` for the
    dense program): dropped workers' deltas leave the reduce, their EF
    residuals stay frozen, and every worker, the dropped ones included,
    resets to the new outer params (rejoining is the broadcast).

    With ``dcfg.sync_delay = d > 0`` the fresh Ψ_r enters the ``pending``
    FIFO while the descent applies ``pending[0]`` = Ψ_{r-d}; communication,
    EF and byte accounting still happen at round r.

    With ``dcfg.outer_enabled=False`` (the DP config) the synced params are
    the K-mean of the worker params (``w[0]`` at K = 1), broadcast back: no
    outer transform, no compression, and no use of ``outer_opt`` or ``ef``.

    On a tensor-parallel round (``collectives.model_group``) the worker
    params are gathered whole over 'model' first and split back to this
    rank's blocks after the reset, so Δ, the wire, EF, the streaming masks
    and the outer update see the leaves the one process does.
    """
    if model_group() is None:
        return _outer_step(dcfg, state, mask, outer, participation)
    state["worker_params"] = gather_model(state["worker_params"])
    state, psi = _outer_step(dcfg, state, mask, outer, participation)
    state["worker_params"] = split_model(state["worker_params"])
    return state, psi


def _outer_step(dcfg: DiLoCoConfig, state: dict, mask: Tree | None, outer: OuterOptimizer | None,
                participation) -> tuple[dict, Tree]:
    if participation is _FROM_STATE:
        participation = state.get("participation")
    if not dcfg.outer_enabled:
        if mask is not None:
            raise ValueError(
                "streaming (partitioned) sync requires the outer optimizer; "
                "outer_enabled=False cannot be combined with streaming_partitions > 1")
        if dcfg.n_workers == 1:  # a K = 1 elastic mask is always all-ones
            participation = None
        # on a mesh the workers are gathered across 'pod' (the identity at
        # pod = 1, the DP layout) and the synced params laid out in the
        # outer state's ZeRO layout
        psi = tree_map(lambda o, w: participation_mean(gather_workers(_delta(o, w)),
                                                       participation),
                       state["outer_params"], state["worker_params"])
        if dcfg.n_workers == 1:  # the synced params are the worker's own: no reset
            tree_map(lambda o, w: o.copy_(like(o, w[0])),
                     state["outer_params"], state["worker_params"])
            state["round"].add_(1)
            return state, psi
        new_outer = tree_map(
            lambda o, w: participation_mean(gather_workers(w).float(), participation).to(o.dtype),
            state["outer_params"], state["worker_params"])
        tree_map(lambda o, n: o.copy_(like(o, n)), state["outer_params"], new_outer)
        del new_outer
        tree_map(lambda o, w: w.copy_(whole(o)[None].to(w.dtype).expand_as(w)),
                 state["outer_params"], state["worker_params"])
        state["round"].add_(1)
        return state, psi
    outer = outer or make_outer(dcfg)
    if dcfg.sync_delay:
        if mask is not None:
            raise ValueError("sync_delay cannot be combined with streaming "
                             "(J>1) segment syncs")
        pending = state.get("pending")
        if pending is None:
            raise ValueError("sync_delay > 0 needs the pending FIFO in the TrainState; "
                             "build it with diloco_init on a config with the same sync_delay")
        psi, new_ef = outer.reduce(state["outer_params"], state["worker_params"],
                                   state.get("ef"), participation=participation, delta=_delta)
        # on a mesh the FIFO holds each slot in the outer state's layout:
        # the descent takes pending[0]'s block beside the outer params'
        # blocks, and the fresh (whole) Psi shifts in as this rank's block
        new_outer, new_opt = outer.descend(
            state["outer_params"],
            tree_map(lambda o, q: from_block(o, local(q)[0]), state["outer_params"], pending),
            state["outer_opt"])
        tree_map(lambda o, q, p: _shift_in(local(q), block(o, p)),
                 state["outer_params"], pending, psi)
    else:
        new_outer, new_opt, new_ef, psi = outer.step(
            state["outer_params"], state["worker_params"], state["outer_opt"], state.get("ef"),
            mask=mask, participation=participation, delta=_delta)
    _copy_into(state["outer_params"], new_outer)
    _copy_into(state["outer_opt"], new_opt)
    if new_ef is not None:
        _copy_into(state["ef"], new_ef)

    # broadcast the synced params back to every worker (masked portions only)
    def reset(o, w, m=None):
        ob = whole(o)[None].to(w.dtype).expand_as(w)
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
                 consts: dict[str, torch.Tensor] | None = None,
                 masked: bool | None = None) -> tuple[dict, dict]:
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

    An elastic state (a ``participation`` field) runs one of two programs:
    the dense one, the lockstep round's own operations, when every worker
    takes part, and the masked one otherwise. ``masked`` names the program;
    the engine passes it from the host's copy of the mask so a captured
    round reads nothing back, and ``None`` reads the state's mask here.
    Both programs report ``comm_bytes`` as c·(sum(p)/K), the reference's op
    order (exactly c at full participation), and ``active_workers`` as
    sum(p).
    """
    H, J = dcfg.sync_interval, dcfg.streaming_partitions
    if batches["tokens"].shape[0] != H:
        raise ValueError(f"batches hold {batches['tokens'].shape[0]} steps, H = {H}")
    if dcfg.sync_delay and J > 1:
        raise ValueError("sync_delay cannot be combined with streaming (J>1) segment syncs")
    if J > 1 and H % J:
        raise ValueError("streaming requires the partition count to divide the sync "
                         f"interval: J={J} does not divide H={H}")
    if J > 1 and masks is None:
        raise ValueError("streaming (J>1) requires partition masks; build them with "
                         "make_streaming_masks(state, dcfg)")
    if consts is None:
        consts = round_constants(state, dcfg, masks)
    participation = state.get("participation")
    metrics = dict(consts)
    if participation is not None:
        if masked is None:
            masked = not bool((participation > 0).all())
        with torch.no_grad():
            p = participation.float()
            metrics["comm_bytes"] = consts["comm_bytes"] * (torch.sum(p) / float(dcfg.n_workers))
            metrics["active_workers"] = torch.sum(p)
    part = participation if masked else None
    seg = H // max(J, 1)
    losses, psi = [], None
    for j in range(max(J, 1)):
        for h in range(j * seg, (j + 1) * seg):
            state, m = inner_step(model, opt, state, {n: v[h] for n, v in batches.items()},
                                  participation=part)
            losses.append(m["loss"])
        if J <= 1:
            state, psi = outer_step(dcfg, state, outer=outer, participation=part)
            continue
        state, psi_j = outer_step(dcfg, state, mask=masks[j], outer=outer, participation=part)
        # psi leaves have no K axis: the masks broadcast directly
        masked_j = tree_map(lambda m, p: m * p, masks[j], psi_j)
        psi = masked_j if psi is None else tree_map(torch.add, psi, masked_j)
    losses = torch.stack(losses)
    info = {"loss": losses, "psi": psi, **metrics}
    if "health" in state:
        with torch.no_grad():
            new_health, flag = health_update(dcfg.health, state["health"], losses, psi)
            _copy_into(state["health"], new_health)
        info["health"] = flag
    return state, info


# ---------------------------------------------------------------------------
# The data-parallel baseline: the degenerate (K=1, H=1, no-outer) config.
# dp_init / dp_step are thin adapters over the inner step DiLoCo runs.
# ---------------------------------------------------------------------------


def dp_init(model, inner_name: str, inner_cfg: OptimizerConfig, gen: torch.Generator,
            device) -> tuple[dict, Any]:
    """``({"params", "opt_state"}, opt)`` of a fresh DP run."""
    params = model.init(gen, device)
    opt = make_inner_optimizer(inner_name, inner_cfg)
    return {"params": params, "opt_state": opt.init(params)}, opt


def dp_step(model, opt, state: dict, batch: dict) -> tuple[dict, dict]:
    """One DP step = one DiLoCo inner step at K = 1 (the same code). The
    params and optimizer state update in place, through K = 1 views."""
    stacked = {"worker_params": tree_map(lambda p: p[None], state["params"]),
               "inner_state": tree_map(lambda s: s[None], state["opt_state"])}
    _, metrics = inner_step(model, opt, stacked, {k: v[None] for k, v in batch.items()})
    return state, {"loss": metrics["loss"]}
