"""Communication collectives for the pseudogradient all-reduce (port of
``repro/core/collectives.py``; paper §2, App. C.1).

The quantized collective is an all-to-all reduce-scatter followed by a ring
all-gather: each worker's quantized shard is dequantized and reduced once
in fp32 on its owner, re-quantized and all-gathered — exactly two
quantize / dequantize points (Q1/D1, Q2/D2). Top-k uses an all-gather and a
local reduce (one compression). The reduce consumes the wire buffers the
worker stage emitted (:mod:`repro_torch.core.wire`). Workers live on a
stacked leading K axis, so the mean over axis 0 is the all-reduce.

On a mesh of ranks (``launch/mesh.py``) each rank holds its own workers
(K -> 'pod'), and :class:`mesh_groups` names the process groups of the
mesh's axes: :func:`gather_workers` all-gathers a worker-stacked buffer
(a wire packet's buffers, or dense deltas) across 'pod' in rank order, so
the reduce then sums the same [K, ...] stack in ``_sum_workers``'s order
on every rank and gives the bits of the one-process reduce;
:func:`data_mean` averages a worker's gradients over the ranks that split
its batch ('data'); :func:`local_workers` takes the rank's slice of a [K]
per-worker tensor (the participation mask); :func:`whole` rebuilds a
DTensor leaf of the outer state (kept in its ZeRO layout) whole on every
rank, :func:`like` lays a whole tensor out as a DTensor leaf, and
:func:`local` / :func:`block` / :func:`from_block` move between a leaf
and this rank's block of it (a streaming mask's block, the sync delay's
FIFO slot). With no groups installed and plain tensors each is the
identity, so the one-process path is unchanged.

Tensor parallelism over 'model' (the reference's compute layout:
``launch/sharding.param_spec`` puts every weight's last dim on 'model' and
``launch/steps.activation_rules`` lays the residual stream and the FFN
hidden over it, so GSPMD splits each worker's forward and backward), written
out by hand, Megatron's way. When :class:`MeshGroups` names a ``model``
group, each rank holds its block of every worker's block matrices
(:func:`split_dim`: column-parallel ``wq`` / ``wk`` / ``wv`` / ``w_in`` /
``w_gate`` split along dim -1, row-parallel ``wo`` / ``w_out`` along dim
-2) and every other leaf whole. Each rank projects its own heads and FFN
columns, and two conjugate exchanges over ``launch/mesh.all_reduce_sum``
(summed in fp32 in rank order, cast once) carry the split:
:func:`copy_in` (identity forward, gradient summed over 'model' backward)
at each column-parallel input and at :func:`shared_weight` (QK-norm's
scales, applied to the rank's heads only), and :func:`reduce_out` (the
partials summed forward, identity backward) after each row-parallel
product. :func:`on_whole` runs a function on a split leaf gathered whole
(Muon's Newton-Schulz), :func:`whole_shape` reads a split leaf's whole
shape, and :func:`gather_model` / :func:`split_model` move a tree of worker
leaves between whole and split (the outer sync runs on whole leaves). The
sums' bytes count under ``launch/mesh.RECEIVED['model']``, the gathers'
under ``'model_momentum'`` (Muon) and ``'model_sync'`` (the sync).

Byte accounting: :func:`measured_sync_bytes` sizes the buffers the
collective moves (codes, row metadata, indices, packing padding) in closed
form from the leaf shapes, allocating nothing; it is the per-round
``comm_bytes`` metric. :func:`collective_bytes_tree` is the reference's
closed-form model (Tab. 10 / Fig. 16).
"""
from __future__ import annotations

import dataclasses
import math
from contextvars import ContextVar
from typing import Any

import torch

from repro_torch.core.compression import CompressionConfig, ef_accumulate
from repro_torch.core.wire import _row_layout, decode_leaf, encode_leaf
from repro_torch.kernels.quantize import packed_width
from repro_torch.utils.tree import tree_leaves, tree_map, tree_map_with_path, tree_unzip

Tree = Any


@dataclasses.dataclass(frozen=True)
class MeshGroups:
    """The process groups a mesh round exchanges over: ``workers`` ('pod':
    each rank holds K / pod workers), ``data`` (each rank holds B / data
    rows of its workers' batches) and ``model`` (on a tensor-parallel round
    only: each rank holds its block of every worker's split matrices); None
    where the axis has one rank or does not split."""

    workers: Any = None
    data: Any = None
    model: Any = None


_GROUPS: ContextVar[MeshGroups | None] = ContextVar("mesh_groups", default=None)


class mesh_groups:
    """Context manager installing a round's :class:`MeshGroups` (None: one
    process holds every worker and every batch row)."""

    def __init__(self, groups: MeshGroups | None):
        self.groups = groups
        self._toks: list = []

    def __enter__(self):
        self._toks.append(_GROUPS.set(self.groups))
        return self

    def __exit__(self, *exc):
        _GROUPS.reset(self._toks.pop())
        return False


def gather_workers(x):
    """A rank's worker-stacked [K_local, ...] tensor or wire packet,
    all-gathered across 'pod' into the [K, ...] stack of every worker (the
    identity with no mesh installed)."""
    groups = _GROUPS.get()
    if groups is None or groups.workers is None:
        return x
    from repro_torch.core.wire import _BUFFERS, is_wire
    from repro_torch.launch.mesh import all_gather

    if not is_wire(x):
        return all_gather(x, groups.workers, tag="workers")
    fields = {f: all_gather(getattr(x, f), groups.workers, tag="wire")
              for f in _BUFFERS[type(x)]}
    n = fields[_BUFFERS[type(x)][0]].shape[0] // getattr(x, _BUFFERS[type(x)][0]).shape[0]
    shape = (x.shape[0] * n, *x.shape[1:])
    return dataclasses.replace(x, shape=shape, **fields)


def data_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the ranks that split a worker's batch
    ('data'): their sum in rank order times 1 / data (the identity with no
    data axis)."""
    groups = _GROUPS.get()
    if groups is None or groups.data is None:
        return x
    import torch.distributed as dist

    from repro_torch.launch.mesh import all_reduce_sum

    return all_reduce_sum(x, groups.data, tag="grads") * (1.0 / dist.get_world_size(groups.data))


def local_workers(x: torch.Tensor) -> torch.Tensor:
    """The rank's [K / pod] slice of a [K] per-worker tensor (the
    participation mask), in ``gather_workers``' order: the identity with no
    'pod' axis."""
    groups = _GROUPS.get()
    if groups is None or groups.workers is None:
        return x
    import torch.distributed as dist

    n = dist.get_world_size(groups.workers)
    k = x.shape[0] // n
    r = dist.get_rank(groups.workers)
    return x[r * k:(r + 1) * k]


# ---------------------------------------------------------------------------
# Tensor parallelism over 'model'
# ---------------------------------------------------------------------------

COLUMN = ("attn/wq", "attn/wk", "attn/wv", "mlp/w_in", "mlp/w_gate")
ROW = ("attn/wo", "mlp/w_out")


def split_dim(path: str) -> int | None:
    """The dim of a leaf that a tensor-parallel worker splits over 'model'
    (-1 column-parallel, -2 row-parallel), or None (the leaf stays whole).
    ``path`` is a param path (``layers/attn/wq``) or the path of a state leaf
    that follows its param (``tx/muon/0/m/layers/attn/wq``)."""
    for names, dim in ((COLUMN, -1), (ROW, -2)):
        if any(path == n or path.endswith("/" + n) for n in names):
            return dim
    return None


def model_group():
    """The installed 'model' group of a tensor-parallel round, or None."""
    groups = _GROUPS.get()
    return None if groups is None else groups.model


def _model_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every 'model' rank's ``x``, in fp32 and rank order, cast
    once to ``x``'s dtype (gloo may not reduce bf16; one cast is also closer
    to the one process's single rounding)."""
    from repro_torch.launch.mesh import all_reduce_sum

    return all_reduce_sum(x.float(), group, tag="model").to(x.dtype)


class _CopyIn(torch.autograd.Function):
    """Identity forward, the gradient summed over 'model' backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _model_sum(grad, ctx.group), None


class _ReduceOut(torch.autograd.Function):
    """The partials summed over 'model' forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _model_sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_in(x: torch.Tensor) -> torch.Tensor:
    """A whole activation entering column-parallel products."""
    group = model_group()
    return x if group is None else _CopyIn.apply(x, group)


def shared_weight(w: torch.Tensor) -> torch.Tensor:
    """A whole weight each rank applies to its own heads only (QK-norm's
    scales): its gradient covers the rank's heads and is summed over
    'model'."""
    group = model_group()
    return w if group is None else _CopyIn.apply(w, group)


def reduce_out(x: torch.Tensor) -> torch.Tensor:
    """A row-parallel product's partial, summed over 'model'."""
    group = model_group()
    return x if group is None else _ReduceOut.apply(x, group)


def model_block(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block of a whole tensor along ``dim`` (a contiguous copy)."""
    import torch.distributed as dist

    return x.chunk(dist.get_world_size(group), dim=dim)[dist.get_rank(group)].contiguous()


def _split(path: str, x) -> int | None:
    dim = split_dim(path)
    return dim if dim is not None and x is not None and x.dim() >= 2 else None


def on_whole(path: str, x: torch.Tensor, fn) -> torch.Tensor:
    """``fn`` of a leaf: a split leaf is gathered whole over 'model', ``fn``
    runs on the whole (the same on every rank) and the rank's block of the
    result is returned; any other leaf goes to ``fn`` as it is."""
    group, dim = model_group(), _split(path, x)
    if group is None or dim is None:
        return fn(x)
    from repro_torch.launch.mesh import all_gather

    return model_block(fn(all_gather(x, group, dim=dim, tag="model_momentum")), dim, group)


def whole_shape(path: str, shape: tuple) -> tuple:
    """The whole leaf's shape of a (possibly split) leaf's ``shape``."""
    group, dim = model_group(), split_dim(path)
    if group is None or dim is None or len(shape) < 2:
        return tuple(shape)
    import torch.distributed as dist

    out = list(shape)
    out[dim] *= dist.get_world_size(group)
    return tuple(out)


def gather_model(tree: Tree, group=None, tag: str = "model_sync") -> Tree:
    """Every split leaf of a tree of worker leaves gathered whole over
    'model' (``group``, or the installed one; the tree as it is with none)."""
    group = group or model_group()
    if group is None:
        return tree
    from repro_torch.launch.mesh import all_gather

    return tree_map_with_path(lambda p, x: x if _split(p, x) is None
                              else all_gather(x, group, dim=_split(p, x), tag=tag), tree)


def split_model(tree: Tree, group=None) -> Tree:
    """Each splittable leaf of a tree of whole leaves as this rank's block."""
    group = group or model_group()
    if group is None:
        return tree
    return tree_map_with_path(lambda p, x: x if _split(p, x) is None
                              else model_block(x, _split(p, x), group), tree)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def whole(x):
    """A DTensor leaf gathered whole on every rank (a plain tensor as it is)."""
    if not _is_dtensor(x):
        return x
    from repro_torch.launch.mesh import gather_whole

    return gather_whole(x.to_local(), x.device_mesh, x.placements, tag="outer")


def local(x):
    """A DTensor's block on this rank (a plain tensor as it is)."""
    return x.to_local() if _is_dtensor(x) else x


def block(ref, x: torch.Tensor) -> torch.Tensor:
    """The rank's block of a whole tensor ``x`` laid out as the DTensor leaf
    ``ref`` is (a slice, no communication), or ``x`` as it is when ``ref``
    is plain. A dimension of ``x`` that broadcasts against ``ref`` (size 1:
    a streaming mask's (L, 1, ...)) stays whole, and so does an ``x`` of
    another dimension count (a 0-dim mask)."""
    if not _is_dtensor(ref):
        return x
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.kernels.partition import local_block

    pl = [Replicate() if isinstance(p, Shard) and (x.dim() != ref.dim() or x.shape[p.dim] == 1)
          else p for p in ref.placements]
    return local_block(x, ref.device_mesh, pl)


def from_block(ref, b: torch.Tensor):
    """The rank's block ``b`` of a tensor laid out as ``ref`` is, as a
    DTensor like ``ref`` (``b`` itself when ``ref`` is plain)."""
    if not _is_dtensor(ref):
        return b
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(b, ref.device_mesh, ref.placements, run_check=False,
                              shape=ref.shape, stride=ref.stride())


def like(ref, x):
    """A whole tensor ``x`` laid out as the DTensor leaf ``ref`` is (its
    block on this rank, a slice), or ``x`` as it is when ``ref`` is plain
    or ``x`` is a DTensor already."""
    if not _is_dtensor(ref) or _is_dtensor(x):
        return x
    return from_block(ref, block(ref, x).contiguous())


def _sum_workers(vals: torch.Tensor) -> torch.Tensor:
    """Sum over the leading K axis in order, ((v0 + v1) + v2) + ..., the
    order XLA reduces a leading axis in (``torch.sum`` takes another order
    for some entries of some shapes)."""
    acc = vals[0]
    for k in range(1, vals.shape[0]):
        acc = acc + vals[k]
    return acc


def participation_mean(vals: torch.Tensor, participation: torch.Tensor | None) -> torch.Tensor:
    """Mean over the leading K axis restricted to participating workers.

    ``participation`` is a [K] fp32 {0, 1} mask (``None`` = everyone). Both
    forms multiply by a reciprocal: ``sum * (1 / K)``, which is what
    ``jnp.mean`` compiles to (a plain division, like ``torch.mean``'s,
    differs in the last ulp whenever 1/K is inexact, e.g. K = 3), and
    ``sum(p * vals) * (1 / max(sum(p), 1))`` with a mask."""
    if participation is None:
        return _sum_workers(vals) * (1.0 / vals.shape[0])
    p = participation.float()
    pb = p.reshape((p.shape[0],) + (1,) * (vals.dim() - 1))
    return _sum_workers(pb * vals) * (1.0 / torch.clamp(p.sum(), min=1.0))


def _q2_d2(psi: torch.Tensor, cfg: CompressionConfig) -> torch.Tensor:
    """The a2a_rs_ag collective re-quantizes the reduced shard (Q2) and the
    all-gather delivers its reconstruction (D2)."""
    if cfg.kind == "quant" and cfg.collective == "a2a_rs_ag":
        return decode_leaf(encode_leaf(psi, cfg, batch_ndim=0), impl=cfg.wire_impl)
    return psi


def reduce_pseudogradients(worker_comm: Tree, cfg: CompressionConfig,
                           participation: torch.Tensor | None = None) -> Tree:
    """Reduce per-worker wire buffers into the pseudogradient Psi: dense
    [K, ...] deltas for ``kind='none'``, wire packets otherwise (decoded,
    D1, then averaged; Q2/D2 for the a2a_rs_ag quantized collective)."""
    if cfg.kind == "none":
        return tree_map(lambda d: participation_mean(gather_workers(d.float()), participation),
                        worker_comm)
    return tree_map(lambda w: _q2_d2(participation_mean(
        decode_leaf(gather_workers(w), impl=cfg.wire_impl), participation), cfg), worker_comm)


def _leaf_wire_pipeline(d: torch.Tensor, e: torch.Tensor | None, cfg: CompressionConfig,
                        participation: torch.Tensor | None = None):
    """The whole per-leaf wire path on a [K, ...] delta leaf: (EF accumulate
    ->) Q1 -> D1 -> mean over K (-> Q2/D2), decoding Q1 once for both the
    residual and the mean. Mirrors the stage chain leafwise. Returns
    ``(psi fp32, new_residual fp32 | None)``."""
    acc = ef_accumulate(cfg, d, e) if e is not None else None
    packet = encode_leaf(acc if acc is not None else d, cfg, batch_ndim=1)
    vals = decode_leaf(packet, impl=cfg.wire_impl)  # D1: the true reconstruction
    new_e = acc - vals if acc is not None else None
    groups = _GROUPS.get()
    if groups is not None and groups.workers is not None:  # the packets cross 'pod'
        vals = decode_leaf(gather_workers(packet), impl=cfg.wire_impl)
    return _q2_d2(participation_mean(vals, participation), cfg), new_e


def segment_sync_update(deltas: Tree, residuals: Tree | None, mask: Tree,
                        cfg: CompressionConfig,
                        participation: torch.Tensor | None = None):
    """One streaming segment's worker and reduce stages with wire-row
    subsetting: per leaf, the mask decides (``streaming.subset_plan``)
    whether to encode the whole leaf, nothing, only its owned L-rows (a
    smaller wire buffer), or the full-size masked encode (``'legacy'``).

    ``deltas`` are the mask-multiplied [K, ...] worker deltas, ``residuals``
    the K-stacked EF tree or ``None``. Returns ``(psi, new_residuals)``.
    For ``'skip'`` / ``'rows'`` leaves psi is zero outside the partition and
    unowned residual rows come back unchanged; callers still mask psi and
    merge the residuals under the mask, for the ``'legacy'`` leaves."""
    from repro_torch.core.streaming import subset_index, subset_plan

    def per_leaf(d, e, m):
        plan, idx = subset_plan(m, tuple(d.shape[1:]), cfg)
        if plan == "skip":
            return torch.zeros(d.shape[1:], dtype=torch.float32, device=d.device), e
        if plan == "rows":
            rows = subset_index(m, idx, d.device)
            psi_sub, new_e_sub = _leaf_wire_pipeline(
                d[:, rows], e[:, rows] if e is not None else None, cfg, participation)
            psi = torch.zeros(d.shape[1:], dtype=torch.float32, device=d.device)
            psi[rows] = psi_sub
            new_e = None
            if e is not None:
                new_e = e.float().clone()
                new_e[:, rows] = new_e_sub
            return psi, new_e
        return _leaf_wire_pipeline(d, e, cfg, participation)  # 'all' / 'legacy'

    if residuals is None:
        psi, _ = tree_unzip(tree_map(lambda d, m: per_leaf(d, None, m), deltas, mask), 2)
        return psi, None
    return tree_unzip(tree_map(per_leaf, deltas, residuals, mask), 2)


def reduce_mean(cfg: CompressionConfig, participation: torch.Tensor | None = None):
    """The pseudogradient all-reduce as a stateless transform stage:
    [K, ...]-stacked wire buffers (or dense deltas for kind='none') -> Psi."""
    from repro_torch.optim.transform import stateless

    return stateless(lambda comm, _params: reduce_pseudogradients(
        comm, cfg, participation=participation))


# ---------------------------------------------------------------------------
# Byte accounting
# ---------------------------------------------------------------------------


def _wire_bytes(shape: tuple, cfg: CompressionConfig, batch_ndim: int) -> int:
    """Bytes of the packet ``encode_leaf`` makes of an fp32 leaf of this
    shape, from the shape alone."""
    if cfg.kind == "topk":
        inner = math.prod(shape[batch_ndim:])
        k = max(int(round(cfg.topk_frac * inner)), 1)
        return math.prod(shape[:batch_ndim]) * k * (4 + 4)  # int32 index + fp32 value
    if cfg.kind == "quant":
        rows, cols = _row_layout(shape, cfg.rowwise, batch_ndim)
        meta = 4 * (1 << cfg.bits) if cfg.quant_mode == "statistical" else 4 + 4
        return rows * (packed_width(cols, cfg.bits) + meta)
    raise ValueError(f"unknown compressor {cfg.kind!r}")


def _leaf_sync_bytes(shape: tuple, cfg: CompressionConfig, n_workers: int) -> float:
    """Measured per-sync wire bytes per worker for one parameter leaf:

    * dense (kind='none'): fp32 reduce-scatter + all-gather = 2 full leaves;
    * quant 'a2a_rs_ag': the worker's Q1 buffer out + the Q2 buffer in;
    * quant / top-k 'gather': every worker receives all K workers' buffers.
    """
    K = n_workers
    if cfg.kind == "none":
        return 2.0 * math.prod(shape) * 4
    q1_per_worker = _wire_bytes((K, *shape), cfg, 1) / K
    if cfg.kind == "quant" and cfg.collective == "a2a_rs_ag":
        return q1_per_worker + _wire_bytes(shape, cfg, 0)
    return q1_per_worker * K


def _mask_fraction(m) -> float:
    return float(m.float().mean()) if isinstance(m, torch.Tensor) else float(m)


def measured_sync_bytes(params: Tree, cfg: CompressionConfig, n_workers: int,
                        mask: Tree | None = None, outer_enabled: bool = True) -> int:
    """Measured wire bytes per outer sync per worker, from the sizes of the
    buffers the collective moves. Only the leaves' shapes are read.

    With a streaming partition ``mask`` the accounting follows the
    ``subset_plan`` the segment sync executes: wholly owned leaves count in
    full, unowned leaves not at all, ``'rows'`` leaves at the size of the
    subset they encode (so per-segment totals sum exactly to the single
    sync's), ``'legacy'`` leaves at the masked-row fraction. With
    ``outer_enabled=False`` the sync is the dense K-way parameter average
    (nothing at all for K == 1)."""
    from repro_torch.core.streaming import subset_plan

    leaves = tree_leaves(params)
    mask_leaves = tree_leaves(mask) if mask is not None else [None] * len(leaves)
    total = 0.0
    for p, m in zip(leaves, mask_leaves):
        shape = tuple(p.shape)
        if not outer_enabled:
            frac = 1.0 if m is None else _mask_fraction(m)
            total += frac * (0.0 if n_workers == 1 else 2.0 * math.prod(shape) * 4)
            continue
        if m is None or cfg.kind == "none":
            frac = 1.0 if m is None else _mask_fraction(m)
            total += frac * _leaf_sync_bytes(shape, cfg, n_workers)
            continue
        plan, idx = subset_plan(m, shape, cfg)
        if plan == "rows":  # the subset the segment encodes
            total += _leaf_sync_bytes((len(idx), *shape[1:]), cfg, n_workers)
        elif plan == "all":
            total += _leaf_sync_bytes(shape, cfg, n_workers)
        elif plan == "legacy":
            total += _mask_fraction(m) * _leaf_sync_bytes(shape, cfg, n_workers)
    return int(round(total))


def measured_compression_ratio(params: Tree, cfg: CompressionConfig, n_workers: int) -> float:
    """Measured wire bytes vs the dense fp32 collective on the same tree."""
    dense = measured_sync_bytes(params, CompressionConfig(kind="none"), n_workers)
    return measured_sync_bytes(params, cfg, n_workers) / max(dense, 1)


def collective_bytes_tree(params: Tree, cfg: CompressionConfig, n_workers: int) -> dict:
    """Modeled wire bytes per outer sync per worker (Tab. 10 / Fig. 16):

    dense ring all-reduce:   2 * P * 4 bytes (reduce-scatter + all-gather)
    quant a2a_rs + ring ag:  2 * P * bits/8
    top-k all-gather:        K * kept * (4 + 4) bytes (value + index)
    """
    n = sum(math.prod(tuple(p.shape)) for p in tree_leaves(params))
    if cfg.kind == "none":
        per_worker = 2 * n * 4
    elif cfg.kind == "quant":
        per_worker = int(2 * n * cfg.bits / 8)
    elif cfg.kind == "topk":
        per_worker = n_workers * int(n * cfg.topk_frac) * 8
    else:
        raise ValueError(cfg.kind)
    return {"params": n, "bytes_per_sync_per_worker": per_worker}
