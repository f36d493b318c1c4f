"""Meshes of ranks (port of ``repro/launch/mesh.py``) and the one transport
the mesh's collectives take.

Single pod:  (data=16, model=16)            — 256 ranks
Multi-pod:   (pod=2, data=16, model=16)     — 512 ranks

The ``pod`` axis is the DiLoCo worker axis: each pod holds its workers, and
only the every-H-steps pseudogradient exchange crosses it. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the process
group that is already initialised; the caller initialises it
(``torch.distributed.init_process_group`` with its address, world size and
rank; ``launch/train.py`` does it from ``torchrun``'s environment). Importing
this module initialises nothing.

The transport. Every collective of the port's mesh code goes through
:func:`all_gather` and :func:`all_reduce_sum` here (and a checkpoint's
worker trees through :func:`gather_host`, to the writer's host only). On NCCL (one card per
rank) they are ``torch.distributed``'s own calls on the device. Gloo, the
backend of the CPU tests and of two ranks that share one card (NCCL refuses
two ranks on one device), has no collective for CUDA tensors that the port
can rely on, so a CUDA tensor on a gloo group is staged through pinned host
memory: copied to the host, exchanged there, copied back. The staging is
logged once per process (:data:`STAGED`) and is a transport only: it moves
the same bytes, and no kernel gives way to its plain version for it.
Beside the rounds' tensors, ``run_rounds`` agrees on a few host numbers over
the world (:func:`host_max`: health flags and the stop flag;
:func:`host_broadcast`: the checkpoint round rank 0 picked), on the CPU
under gloo and on the rank's card under NCCL.
"""
from __future__ import annotations

import sys
from typing import Any

import torch

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}

# collective name -> times a CUDA tensor was staged through host memory
STAGED: dict[str, int] = {}
# what was gathered -> bytes this rank received from the other ranks (all
# gathers of the mesh code; ``reset_traffic`` zeroes it)
RECEIVED: dict[str, int] = {}


def reset_traffic() -> None:
    RECEIVED.clear()


def _mesh(shape: tuple[int, ...], names: tuple[str, ...], device_type: str | None):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    n = 1
    for s in shape:
        n *= s
    if n != dist.get_world_size():
        raise ValueError(f"a mesh of {'x'.join(map(str, shape))} = {n} ranks, but the "
                         f"process group has {dist.get_world_size()}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(shape), mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device_type: str | None = None):
    """16x16 (data, model), or 2x16x16 (pod, data, model) with ``multi_pod``,
    over the initialised world (256 or 512 ranks; the dry run's fake world)."""
    shape, names = PRODUCTION[multi_pod]
    return _mesh(shape, names, device_type)


def make_debug_mesh(data: int = 1, model: int = 1, pod: int = 0,
                    device_type: str | None = None):
    """A small mesh over however many ranks the initialised world has (for
    tests and ``--mesh``): (pod, data, model) with ``pod``, else (data, model).
    ``device_type`` is the DeviceMesh's (default: ``cuda`` on NCCL, else
    ``cpu``; gloo ranks that hold CUDA tensors pass ``cuda``)."""
    if pod:
        return _mesh((pod, data, model), ("pod", "data", "model"), device_type)
    return _mesh((data, model), ("data", "model"), device_type)


def mesh_axis_sizes(mesh: Any) -> dict[str, int]:
    """``{axis name: size}`` of a DeviceMesh, or of a dict of sizes as given
    (the rules of ``launch/sharding.py`` take either)."""
    if mesh is None:
        return {}
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_size(mesh: Any) -> int:
    n = 1
    for s in mesh_axis_sizes(mesh).values():
        n *= s
    return n


# ---------------------------------------------------------------------------
# The transport
# ---------------------------------------------------------------------------


def _staged(group, t: torch.Tensor) -> bool:
    import torch.distributed as dist

    return t.is_cuda and dist.get_backend(group) == "gloo"


def host_staged(mesh) -> bool:
    """Whether a DeviceMesh's collectives stage CUDA tensors through pinned
    host memory (gloo on the card); False for a CPU mesh, NCCL or a dict of
    axis sizes."""
    if getattr(mesh, "device_type", None) != "cuda":
        return False
    import torch.distributed as dist

    return dist.get_backend(mesh.get_group(0)) == "gloo"


def _note(name: str) -> None:
    if name not in STAGED:
        print(f"mesh transport: {name} of CUDA tensors on gloo staged through pinned host "
              "memory (logged once)", file=sys.stderr, flush=True)
        STAGED[name] = 0
    STAGED[name] += 1


def all_gather(t: torch.Tensor, group, dim: int = 0, tag: str = "other") -> torch.Tensor:
    """The group's ranks' ``t`` concatenated along ``dim`` in rank order
    (every rank's ``t`` has one shape). One rank returns ``t`` itself. The
    bytes received count under ``RECEIVED[tag]``."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    if n == 1:
        return t
    src = t.contiguous()
    RECEIVED[tag] = RECEIVED.get(tag, 0) + (n - 1) * src.numel() * src.element_size()
    if _staged(group, src):
        _note("all_gather")
        host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        host.copy_(src)
        parts = [torch.empty_like(host) for _ in range(n)]
        dist.all_gather(parts, host, group=group)
        return torch.cat(parts, dim=dim).to(src.device)
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim)


def gather_host(t: torch.Tensor, group, tag: str = "other") -> torch.Tensor | None:
    """The group's ranks' ``t`` concatenated along dim 0 in rank order, on
    the host of the group's first rank (None on the others): a checkpoint's
    gather, which only the writer needs and which goes to the host anyway.
    Under gloo a CUDA tensor crosses as a host copy; under NCCL the gather
    runs on the card and its result is copied to the host."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    if n == 1:
        return t.detach().to("cpu", copy=True)
    src = t.detach().contiguous()
    if dist.get_backend(group) == "gloo":
        src = src.cpu()
    dst = dist.get_global_rank(group, 0)
    first = dist.get_rank() == dst
    if first:
        RECEIVED[tag] = RECEIVED.get(tag, 0) + (n - 1) * src.numel() * src.element_size()
    parts = [torch.empty_like(src) for _ in range(n)] if first else None
    dist.gather(src, parts, dst=dst, group=group)
    return torch.cat(parts).cpu() if first else None


def all_reduce_sum(t: torch.Tensor, group, tag: str = "other") -> torch.Tensor:
    """The sum of the group's ranks' ``t``, in rank order: gathered, then
    added ((t0 + t1) + t2) + ..., so every rank gets the same bits whatever
    the backend's own reduction order."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    if n == 1:
        return t
    parts = all_gather(t.unsqueeze(0), group, tag=tag)
    acc = parts[0]
    for i in range(1, n):
        acc = acc + parts[i]
    return acc


def gather_whole(local: torch.Tensor, mesh, placements, tag: str = "other") -> torch.Tensor:
    """The whole tensor of a local block laid out by ``placements`` (one per
    mesh dimension, ``Shard(d)`` or ``Replicate()``): gathered over the
    innermost sharded mesh dimension first, so a tensor dimension sharded
    over two mesh dimensions is rebuilt major-to-minor (pod-major for
    ('pod', 'data'), as JAX lays it out)."""
    from torch.distributed.tensor import Shard

    out = local
    for i in reversed(range(len(placements))):
        p = placements[i]
        if isinstance(p, Shard):
            out = all_gather(out, mesh.get_group(i), dim=p.dim, tag=tag)
    return out


# ---------------------------------------------------------------------------
# Host-side agreement (run_rounds' flags, the checkpoint a resume loads)
# ---------------------------------------------------------------------------


def _host_device():
    import torch.distributed as dist

    return torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl" \
        else torch.device("cpu")


def host_max(values: list[float]) -> list[float]:
    """The element-wise max of a host list over every rank of the world (a
    float64 all-reduce; the list as it is in a world of one)."""
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() == 1 or not values:
        return list(values)
    t = torch.tensor(values, dtype=torch.float64, device=_host_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t.cpu().tolist()


def host_broadcast(value: int) -> int:
    """Rank 0's integer on every rank of the world."""
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() == 1:
        return value
    t = torch.tensor([value], dtype=torch.int64, device=_host_device())
    dist.broadcast(t, src=0)
    return int(t.item())
