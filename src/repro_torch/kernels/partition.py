"""Kernel partitioning: every kernel wrapper's routing on a mesh of ranks
(port of ``repro/kernels/partition.py``).

The reference wraps each Pallas call in ``shard_map`` so that every device
runs the kernel on its local block. The port does the same on a
``torch.distributed`` DeviceMesh: :func:`shard_wrap` lays each operand out
by the kernel's spec (a tuple of mesh-axis names per dimension, the
reference's PartitionSpec), hands the rank's local block to the kernel's
wrapper body, and returns the outputs laid out by their specs. Nothing
inside the wrapped function communicates. All five kernels are
embarrassingly parallel over the axes they shard (the fused batch·kv-head
rows of flash attention, quantize rows, stacked Newton-Schulz matrices,
elementwise outer updates in the state's own layout, serving batch slots),
and the Hopper kernels mask ragged edges on the local shape, so the
result is bitwise the single-process call on the whole tensor.

What an operand is:

* a ``DTensor`` is redistributed to the spec's placements (from
  ``Replicate`` a local slice, no communication) and its local block taken;
  the outputs come back as DTensors in the out specs' placements;
* a plain tensor is the rank's local block already (the mesh trainer's
  compute layout: each rank holds its own workers and its own batch rows),
  and runs as given; with ``plain_whole=True`` (the mesh serving engine,
  whose ranks hold every slot, and the trainer's Newton-Schulz call, whose
  momentum stack is whole on every 'data' rank: ``ops.ns_orthogonalize``) a
  plain tensor is the whole tensor, present on every rank: its local block
  is sliced by the spec, and the outputs are gathered back whole
  (:func:`repro_torch.launch.mesh.gather_whole`).

The routing lives in a ContextVar (:func:`kernel_partitioning`), installed
by the engines and the step plans around every step; the wrappers in
``kernels/ops.py`` and ``kernels/flash_attention.py`` read it per call
(:func:`active_partitioning`). With none installed they behave exactly as
before, one process on the whole tensor.

Axis preferences degrade as in the reference: :func:`axes_for` takes the
longest prefix of the preferred mesh axes whose product divides the
dimension, and an empty result replicates.
"""
from __future__ import annotations

import dataclasses
from contextvars import ContextVar
from typing import Any, Callable

Spec = tuple  # per dimension: None, an axis name, or a tuple of axis names


@dataclasses.dataclass(frozen=True)
class KernelPartitioning:
    """A mesh (a DeviceMesh, or a dict of axis sizes for the rules alone)
    and each kernel's preferred mesh axes, the reference's defaults:

    * ``flash_axes`` — the fused [B·KV, S, G, hd] batch-head axis, B-major,
      so ('data', 'model') puts batch on 'data' and kv heads on 'model';
    * ``quantize_axes`` — wire-quantize rows ([K-folded rows, n]; 'pod'
      leads, as K folds into the rows);
    * ``ns_axes`` — the stacked-matrix axis of Newton-Schulz;
    * ``paged_axes`` — the serving batch slots of paged decode (the page
      table rides along, the KV pool is replicated);
    * ``outer_tp`` — whether the outer-state layout shards dim -1 over
      'model' (``outer_update_spec``).

    ``plain_whole`` says what a plain tensor given to a wrapper is: the
    rank's local block (False) or the whole tensor on every rank (True).
    """

    mesh: Any
    flash_axes: tuple[str, ...] = ("data", "model")
    quantize_axes: tuple[str, ...] = ("pod", "data")
    ns_axes: tuple[str, ...] = ("data",)
    paged_axes: tuple[str, ...] = ("data",)
    outer_tp: bool = True
    plain_whole: bool = False

    def axis_sizes(self) -> dict[str, int]:
        from repro_torch.launch.mesh import mesh_axis_sizes

        return mesh_axis_sizes(self.mesh)


_KERNEL_PARTS: ContextVar[KernelPartitioning | None] = ContextVar("kernel_parts", default=None)


class kernel_partitioning:
    """Context manager installing a routing; ``parts=None`` installs none,
    so call sites can enter it unconditionally::

        with kernel_partitioning(kernel_specs(mesh, cfg)):
            state, info = engine.step(state, batches)
    """

    def __init__(self, parts: KernelPartitioning | None):
        self.parts = parts
        self._toks: list = []  # a stack: one instance may be re-entered

    def __enter__(self):
        self._toks.append(_KERNEL_PARTS.set(self.parts))
        return self

    def __exit__(self, *exc):
        _KERNEL_PARTS.reset(self._toks.pop())
        return False


def active_partitioning() -> KernelPartitioning | None:
    """The installed routing, or None (one process, whole tensors)."""
    return _KERNEL_PARTS.get()


def axes_for(part: KernelPartitioning, dim: int, prefer: tuple[str, ...]) -> tuple[str, ...]:
    """Longest prefix of ``prefer`` whose mesh-size product divides ``dim``
    (axes of size 1 or absent are passed over); empty means replicate."""
    sizes = part.axis_sizes()
    chosen: list[str] = []
    prod = 1
    for name in prefer:
        n = sizes.get(name, 1)
        if n <= 1:
            continue
        if dim % (prod * n):
            break
        chosen.append(name)
        prod *= n
    return tuple(chosen)


def axes_entry(axes: tuple[str, ...]):
    """One spec entry of ``axes``: None for none, the name for one, the tuple
    for more (how JAX's PartitionSpec normalizes its entries)."""
    return None if not axes else axes[0] if len(axes) == 1 else tuple(axes)


def spec_placements(mesh, spec: Spec) -> list:
    """DTensor placements (one per mesh dimension) of a spec: a dimension
    on an axis name is ``Shard(d)`` on that mesh dimension, on a tuple of
    names ``Shard(d)`` on each (major to minor in the mesh's order, as
    JAX's ``P(('pod', 'data'))``); every other mesh dimension replicates.
    Names the mesh lacks are passed over."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out: list = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            if name in names:
                out[names.index(name)] = Shard(d)
    return out


def local_block(t, mesh, placements):
    """The rank's block of a whole tensor ``t`` under ``placements`` (a
    slice, no communication)."""
    from torch.distributed.tensor import Shard

    out = t
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            n = mesh.size(i)
            out = out.chunk(n, dim=p.dim)[mesh.get_local_rank(i)]
    return out


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def shard_wrap(fn: Callable, part: KernelPartitioning, in_specs: tuple,
               out_specs: Any) -> Callable:
    """``fn`` run on each rank's local block (see the module docstring for
    what an operand is). ``out_specs`` is one spec or a tuple of specs, as
    ``fn`` returns one tensor or a tuple; a spec's length is its tensor's
    dimension count. With no DTensor operand and ``plain_whole`` off, the
    operands are local blocks already and ``fn`` runs on them as given."""

    def wrapped(*args):
        dt = any(_is_dtensor(a) for a in args)
        if not dt and not part.plain_whole:
            return fn(*args)
        from torch.distributed.tensor import DTensor

        from repro_torch.launch.mesh import gather_whole

        mesh = part.mesh
        local = []
        for a, spec in zip(args, in_specs):
            pl = spec_placements(mesh, spec)
            if _is_dtensor(a):
                local.append(a.redistribute(mesh, pl).to_local())
            else:
                local.append(local_block(a, mesh, pl))
        out = fn(*local)
        single = not isinstance(out, tuple)
        outs = (out,) if single else out
        specs = (out_specs,) if single else out_specs
        if dt:
            res = tuple(DTensor.from_local(o, mesh, spec_placements(mesh, s), run_check=False)
                        for o, s in zip(outs, specs))
        else:
            res = tuple(gather_whole(o, mesh, spec_placements(mesh, s), tag="kernels")
                        for o, s in zip(outs, specs))
        return res[0] if single else res

    return wrapped
