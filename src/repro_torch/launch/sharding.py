"""Sharding rules: every tree leaf's spec on a mesh (port of
``repro/launch/sharding.py``), and their DTensor placements.

A spec is the reference's PartitionSpec as a tuple of mesh-axis names per
dimension (:class:`P`: None, a name, or a tuple of names), so the rules can
be held against the reference's leaf for leaf; :func:`placements` turns one
into DTensor placements (a dimension on ('pod', 'data') becomes ``Shard(d)``
on both mesh dimensions, pod-major, as in JAX).

Scheme (the reference's):
  * worker-stacked trees (leading K): K -> 'pod';
  * weight matrices [..., m, n]: m -> 'data' (FSDP / ZeRO-3), n -> 'model'
    (tensor parallel); MoE expert banks [..., E, m, n]: E -> 'model'
    (expert parallel, serving), m -> 'data';
  * outer/DiLoCo state (params, Nesterov u, EF residuals) has no K axis and
    is sharded over ('pod', 'data') x 'model': the outer optimizer ZeRO'd
    over pods;
  * KV caches / SSM states: batch -> 'data', longest remaining divisible
    axis -> 'model';
  * every rule falls back to replication when a dim is not divisible
    (``_div``), so no shard is ever uneven.

Every function that takes a ``mesh`` takes a DeviceMesh or a dict of axis
sizes (``launch.mesh.mesh_axis_sizes``): the rules need only the sizes.
"""
from __future__ import annotations

from typing import Any

from repro_torch.launch.mesh import mesh_axis_sizes, mesh_size
from repro_torch.utils.tree import tree_map, tree_map_with_path

Tree = Any


class P:
    """A spec: one entry per tensor dimension (None, an axis name, or a
    tuple of axis names), the reference's ``PartitionSpec``. Not a tuple, so
    the port's tree walks take a spec for one leaf."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other):
        return tuple(self) == tuple(other) if isinstance(other, (P, tuple)) else NotImplemented

    def __hash__(self):
        return hash(self.entries)

    def __repr__(self):
        return f"P{self.entries!r}"


def _div(dim: int, n: int) -> bool:
    return n > 0 and dim % n == 0 and dim >= n


def _axis(mesh_sizes: dict[str, int], name: str, dim: int):
    return name if name in mesh_sizes and _div(dim, mesh_sizes[name]) else None


def param_spec(path: str, shape: tuple[int, ...], mesh_sizes: dict[str, int],
               outer: bool = False, tensor_parallel: bool = True,
               expert_parallel: bool = False) -> P:
    """Spec of one (non-K-stacked) parameter / optimizer-state leaf.
    ``outer=True`` folds 'pod' into the FSDP dim (outer-state ZeRO over
    pods); ``tensor_parallel=False`` drops 'model' from weights (heads that
    do not divide the model axis); ``expert_parallel`` shards MoE banks
    E -> 'model' (the serving layout)."""
    nd = len(shape)
    pod_in = outer and "pod" in mesh_sizes
    fsdp: Any = ("pod", "data") if pod_in else "data"
    fsdp_size = mesh_sizes.get("data", 1) * (mesh_sizes.get("pod", 1) if pod_in else 1)

    def fsdp_axis(dim):
        return fsdp if _div(dim, fsdp_size) else (
            "data" if _div(dim, mesh_sizes.get("data", 0)) else None)

    if nd <= 1:
        return P(*([None] * nd))
    spec: list = [None] * nd
    if expert_parallel and nd >= 3 and ("experts" in path):
        spec[-3] = _axis(mesh_sizes, "model", shape[-3])
        spec[-2] = fsdp_axis(shape[-2])
        return P(*spec)
    spec[-2] = fsdp_axis(shape[-2])
    if tensor_parallel:
        spec[-1] = _axis(mesh_sizes, "model", shape[-1])
    return P(*spec)


def worker_spec(path: str, shape: tuple[int, ...], mesh_sizes: dict[str, int],
                tensor_parallel: bool = True) -> P:
    """Spec of a K-stacked leaf: K -> 'pod', the rest per :func:`param_spec`."""
    inner = param_spec(path, shape[1:], mesh_sizes, outer=False,
                       tensor_parallel=tensor_parallel)
    pod = "pod" if ("pod" in mesh_sizes and _div(shape[0], mesh_sizes["pod"])) else None
    return P(pod, *inner)


def cache_spec(shape: tuple[int, ...], batch: int, mesh_sizes: dict[str, int]) -> P:
    """KV-cache / SSM-state leaf: batch -> 'data', longest other -> 'model'
    (the leading layer-stack axis of a >3-D leaf is passed over)."""
    spec: list = [None] * len(shape)
    data_n = mesh_sizes.get("data", 0)
    model_n = mesh_sizes.get("model", 0)
    b_idx = None
    for i, d in enumerate(shape):
        if d == batch and _div(d, data_n):
            b_idx = i
            spec[i] = "data"
            break
    best, best_dim = None, 0
    for i, d in enumerate(shape):
        if i == b_idx or i == 0 and len(shape) > 3:
            continue
        if _div(d, model_n) and d > best_dim:
            best, best_dim = i, d
    if best is not None:
        spec[best] = "model"
    return P(*spec)


def batch_spec(shape: tuple[int, ...], mesh_sizes: dict[str, int], k_stacked: bool = True,
               leading_scan: int = 0) -> P:
    """Spec of one batch leaf: ``leading_scan`` unsharded scan axes ([H, ...]
    round batches: 1, [R, H, ...] superstep batches: 2), then K -> 'pod' and
    B -> 'data' (``k_stacked``) or B -> 'data'."""
    n_lead = int(leading_scan)
    lead = (None,) * n_lead
    shape = tuple(shape[n_lead:])
    nd = len(shape)
    if k_stacked:
        pod = "pod" if ("pod" in mesh_sizes and _div(shape[0], mesh_sizes["pod"])) else None
        data = "data" if (nd > 1 and _div(shape[1], mesh_sizes.get("data", 0))) else None
        return P(*lead, pod, data, *([None] * (nd - 2)))
    data = "data" if _div(shape[0], mesh_sizes.get("data", 0)) else None
    return P(*lead, data, *([None] * (nd - 1)))


# ---------------------------------------------------------------------------
# Tree-level builders (trees of specs)
# ---------------------------------------------------------------------------


def params_shardings(mesh, params: Tree, outer: bool = False, tensor_parallel: bool = True,
                     expert_parallel: bool = False) -> Tree:
    sizes = mesh_axis_sizes(mesh)
    return tree_map_with_path(lambda p, x: param_spec(
        p, tuple(x.shape), sizes, outer=outer, tensor_parallel=tensor_parallel,
        expert_parallel=expert_parallel), params)


def worker_shardings(mesh, tree: Tree, tensor_parallel: bool = True) -> Tree:
    sizes = mesh_axis_sizes(mesh)
    return tree_map_with_path(lambda p, x: worker_spec(
        p, tuple(x.shape), sizes, tensor_parallel=tensor_parallel), tree)


def diloco_state_shardings(mesh, state: dict, tensor_parallel: bool = True) -> dict:
    """Specs of a whole TrainState, field for field: the worker groups
    (``worker_params``, ``inner_state``, ``ef``) per :func:`worker_spec`,
    the outer groups (``outer_params``, ``outer_opt``) in the outer ZeRO
    layout, ``pending`` ([d, ...] FIFO: d whole, the payload in the outer
    layout), and the counters, the [K] participation mask and the health
    stats replicated."""
    sizes = mesh_axis_sizes(mesh)

    def for_group(key, sub):
        if key in ("worker_params", "inner_state", "ef"):
            return worker_shardings(sizes, sub, tensor_parallel=tensor_parallel)
        if key in ("outer_params", "outer_opt"):
            return params_shardings(sizes, sub, outer=True, tensor_parallel=tensor_parallel)
        if key == "pending":
            return tree_map_with_path(lambda p, x: P(None, *param_spec(
                p, tuple(x.shape[1:]), sizes, outer=True,
                tensor_parallel=tensor_parallel)), sub)
        return replicated(sizes, sub)

    return {key: for_group(key, sub) for key, sub in state.items()}


def batch_shardings(mesh, batch: Tree, k_stacked: bool = True, leading_scan: int = 0) -> Tree:
    sizes = mesh_axis_sizes(mesh)
    return tree_map(lambda x: batch_spec(tuple(x.shape), sizes, k_stacked, leading_scan), batch)


def cache_shardings(mesh, cache: Tree, batch: int) -> Tree:
    sizes = mesh_axis_sizes(mesh)
    return tree_map(lambda x: cache_spec(tuple(x.shape), batch, sizes), cache)


def replicated(mesh, tree: Tree) -> Tree:
    return tree_map(lambda x: P(), tree)


# ---------------------------------------------------------------------------
# Specs -> DTensor placements, and placing trees
# ---------------------------------------------------------------------------


def placements(mesh, spec) -> list:
    """DTensor placements of ``spec`` on a DeviceMesh
    (``kernels.partition.spec_placements``)."""
    from repro_torch.kernels.partition import spec_placements

    return spec_placements(mesh, spec)


def place(mesh, tree: Tree, specs: Tree) -> Tree:
    """A tree of whole tensors (the same on every rank: made from one seed,
    or carried in by ``utils.tree.state_from_numpy``) as DTensors laid out
    by ``specs``: each rank keeps its block, a slice, with no communication,
    so a placed state holds the bits of the whole one."""
    from torch.distributed.tensor import DTensor

    from repro_torch.kernels.partition import local_block

    def one(x, spec):
        pl = placements(mesh, spec)
        return DTensor.from_local(local_block(x, mesh, pl).contiguous(), mesh, pl,
                                  run_check=False, shape=x.shape, stride=x.stride())

    return tree_map(one, tree, specs)


# ---------------------------------------------------------------------------
# Kernel partitioning (the routing of the kernel wrappers)
# ---------------------------------------------------------------------------


def kernel_specs(mesh, cfg=None, plain_whole: bool = False):
    """The per-kernel routing of a mesh: one place maps the plan-level
    layout above onto the block-local axes each kernel shards (flash
    attention over ('data', 'model'), or ('data',) where the kv heads do not
    divide the model axis; quantize rows over ('pod', 'data'); the
    Newton-Schulz stack over 'data'; paged decode slots over 'data'; the
    outer update in the outer-state layout, dim -1 on 'model' only for
    tensor-parallel-friendly archs). None for a mesh of one rank.
    ``plain_whole`` as :class:`repro_torch.kernels.partition.KernelPartitioning`.

    Where the mesh stages CUDA tensors through host memory (gloo on the
    card: ``launch/mesh.host_staged``) the Newton-Schulz stack runs whole on
    each rank (``ns_axes=()``): there, gathering the split's results costs
    11-14x the kernel time the split saves (PERF.md, phase 22j)."""
    from repro_torch.kernels.partition import KernelPartitioning
    from repro_torch.launch.mesh import host_staged

    if mesh is None or mesh_size(mesh) <= 1:
        return None
    sizes = mesh_axis_sizes(mesh)
    flash: tuple[str, ...] = ("data", "model")
    outer_tp = True
    if cfg is not None and sizes.get("model", 1) > 1:
        heads = getattr(cfg, "n_kv_heads", 0) or getattr(cfg, "n_heads", 0)
        if heads % sizes["model"]:
            flash = ("data",)
        from repro_torch.launch.steps import tp_friendly

        outer_tp = tp_friendly(cfg, sizes)
    return KernelPartitioning(mesh=mesh, flash_axes=flash, outer_tp=outer_tp,
                              ns_axes=() if host_staged(mesh) else ("data",),
                              plain_whole=plain_whole)
