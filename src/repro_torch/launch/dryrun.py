"""Dry run on a fake world (port of ``repro/launch/dryrun.py``): every step
plan of an (arch, input shape, mesh) placed on a mesh of 256 or 512 ranks in
one CPU process, and recorded.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/dryrun_torch
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch ... --multi-pod

The world is ``torch.distributed``'s ``fake`` backend (every collective
returns at once, moving nothing) and every tensor lives on the ``meta``
device, so nothing is allocated and a 1T-parameter config plans on a host.
Each plan's arguments are placed by their specs (each rank's block a meta
tensor of its local shape), and the plan is called once, as rank 0, under
``torch.distributed.tensor.debug.CommDebugMode``. A record holds, in the
reference's schema (``roofline/report.py`` reads it):

* ``memory.argument_bytes``: rank 0's bytes of the placed arguments, exact
  from the local shapes; ``alias_bytes`` / ``output_bytes`` the donated
  ones. A PyTorch program has no compiler's memory analysis, so
  ``temp_bytes`` and ``peak_per_chip_gib`` are None: not measured;
* ``collectives``: the bytes rank 0 received in the call, by what was
  gathered (``launch.mesh.RECEIVED``: the mesh code's one transport), their
  ``total``, and the collective calls CommDebugMode counted;
* ``roofline``: the per-plan terms of ``repro_torch.roofline.terms.
  analytic_terms`` with the measured collective bytes and, for a sync, the
  round's wire bytes (``core.collectives.measured_sync_bytes``).

The plans run the plain versions (``--attn-impl xla``, ``--ns-impl jnp``,
the plain outer update and wire path: meta tensors compute nothing, and a
kernel launches only on the card). A plan that fails is recorded
``status: error`` with its error.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_config, reduce_config
from repro_torch.configs.base import shape_supported
from repro_torch.utils.tree import tree_leaves

LADDER = ("paper-416m", "paper-15.23b")


def start_fake_world(world: int) -> None:
    """A ``fake`` process group of ``world`` ranks, this process rank 0 (a
    world of another size is torn down first)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor

    total = 0
    for x in tree_leaves(tree):
        t = x.to_local() if isinstance(x, DTensor) else x
        total += t.numel() * t.element_size()
    return total


def _terms(plan, cfg, chips: int, shape: str, spec) -> tuple[float, float]:
    from repro_torch.roofline.terms import abstract_params, analytic_terms

    kind = plan.meta["kind"]
    params = abstract_params(cfg)
    kw = {}
    if kind in ("train", "round", "superstep", "sync"):
        dcfg, state = plan.meta["dcfg"], plan.args[0]
        kw = dict(inner_state=state["inner_state"], outer_opt=state["outer_opt"],
                  inner_name=dcfg.inner_name, n_workers=dcfg.n_workers, H=dcfg.sync_interval,
                  R=plan.meta.get("rounds_per_dispatch", 1))
    elif kind == "decode":
        kw = dict(cache=plan.args[1])
    if spec is None:
        return analytic_terms(kind, cfg, params, shape=shape, chips=chips, **kw)
    return analytic_terms(kind, cfg, params, seq_len=spec[0], global_batch=spec[1],
                          chips=chips, **kw)


def run_one(arch: str, shape: str, multi_pod: bool, *, mesh_shape: tuple | None = None,
            reduced: bool = False, sync_interval: int = 30, inner_name: str = "muon",
            rounds_per_dispatch: int = 4, compression: str = "none", bits: int = 4,
            seq_len: int | None = None, global_batch: int | None = None,
            plan_filter: str | None = None, verbose: bool = True) -> list[dict]:
    """Place and call every step plan of one (arch, shape, mesh) on a fake
    world. ``mesh_shape`` (pod, data, model) replaces the production mesh
    (a small world for tests); ``reduced`` takes ``reduce_config``'s widths,
    and ``seq_len`` / ``global_batch`` override the shape's (the plans keep
    the shape's kind)."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.core.compression import CompressionConfig
    from repro_torch.core.diloco import DiLoCoConfig
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.sharding import kernel_specs
    from repro_torch.launch.steps import build_plans, place_args
    from repro_torch.roofline.analysis import RooflineTerms, active_params, model_flops
    from repro_torch.roofline.terms import param_count

    cfg0 = get_config(arch).replace(attn_impl="xla")
    if reduced:
        cfg0 = reduce_config(cfg0).replace(attn_impl="xla")
    label = ("x".join(map(str, mesh_shape)) if mesh_shape
             else "2x16x16" if multi_pod else "16x16")
    if not shape_supported(cfg0, shape):
        return [{"arch": arch, "shape": shape, "mesh": label, "status": "skipped",
                 "reason": f"{shape} not applicable (the reference's DESIGN.md section 4)"}]
    if mesh_shape:
        start_fake_world(mesh_shape[0] * mesh_shape[1] * mesh_shape[2])
        mesh = mesh_mod.make_debug_mesh(mesh_shape[1], mesh_shape[2], pod=mesh_shape[0],
                                        device_type="cpu")
    else:
        start_fake_world(512 if multi_pod else 256)
        mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    chips = mesh_mod.mesh_size(mesh)
    sizes = mesh_mod.mesh_axis_sizes(mesh)
    spec = INPUT_SHAPES[shape]
    override = None
    if seq_len or global_batch:
        from repro_torch.configs.base import InputShape

        spec = InputShape(shape, seq_len or spec.seq_len, global_batch or spec.global_batch,
                          spec.kind)
        override = (spec.seq_len, spec.global_batch)
    ccfg = CompressionConfig(kind=compression, bits=bits, wire_impl="jnp",
                             collective="gather" if compression == "topk" else "a2a_rs_ag")
    kw = {"input_shape": spec}
    if spec.kind == "train":
        kw["dcfg"] = DiLoCoConfig(n_workers=sizes.get("pod", 1), sync_interval=sync_interval,
                                  inner_name=inner_name, compression=ccfg)
        kw["rounds_per_dispatch"] = rounds_per_dispatch
    plans = build_plans(cfg0, shape, mesh, **kw)
    kparts = kernel_specs(mesh, cfg0)
    partitioning = None if kparts is None else {
        "flash_axes": list(kparts.flash_axes), "quantize_axes": list(kparts.quantize_axes),
        "ns_axes": list(kparts.ns_axes), "paged_axes": list(kparts.paged_axes),
        "outer_tp": kparts.outer_tp}
    records = []
    for plan in plans:
        if plan_filter and plan.name != plan_filter:
            continue
        kind = plan.meta["kind"]
        rec = {"arch": arch, "shape": shape, "plan": plan.name, "mesh": label, "chips": chips,
               "inner": inner_name if kind in ("train", "sync", "round", "superstep") else None,
               "kernels": {"shard_map": kparts is not None, "partitioning": partitioning}}
        t0 = time.time()
        try:
            args = place_args(plan, mesh)
            arg_bytes = _local_bytes(args)
            donated = _local_bytes([args[i] for i in plan.donate])
            mesh_mod.reset_traffic()
            with CommDebugMode() as comm:
                plan.fn(*args)
            received = dict(mesh_mod.RECEIVED)
            cfg = plan.meta["cfg"]
            n = param_count(cfg)
            n_active = active_params(cfg, n)
            flops_chip, bytes_chip = _terms(plan, cfg, chips, shape, override)
            wire = 0.0
            if kind in ("sync", "round", "superstep"):
                from repro_torch.core.collectives import measured_sync_bytes
                from repro_torch.roofline.terms import abstract_params

                dcfg = plan.meta["dcfg"]
                wire = float(measured_sync_bytes(abstract_params(cfg), dcfg.compression,
                                                 dcfg.n_workers)) * plan.meta.get(
                                                     "rounds_per_dispatch", 1)
            tokens = plan.meta["tokens_per_step"]
            terms = RooflineTerms(flops=flops_chip, hlo_bytes=bytes_chip,
                                  collective_bytes=float(sum(received.values())), chips=chips,
                                  model_flops=model_flops(kind, n_active, tokens),
                                  amortize=float(plan.meta["amortize"]), wire_bytes=wire)
            rec.update({
                "status": "ok", "compile_s": round(time.time() - t0, 1), "n_params": n,
                "n_active_params": n_active,
                "memory": {"argument_bytes": arg_bytes, "output_bytes": donated,
                           "alias_bytes": donated, "temp_bytes": None,
                           "peak_per_chip_gib": None},
                "collectives": {"total": int(sum(received.values())),
                                **{k: int(v) for k, v in received.items()},
                                "calls": {str(op): int(c) for op, c in
                                          comm.get_comm_counts().items()}},
                "roofline": terms.as_dict(),
            })
        except Exception as e:  # noqa: BLE001 — record the failure verbatim
            rec.update({"status": "error", "error": f"{type(e).__name__}: {e}",
                        "traceback": traceback.format_exc()[-2000:]})
        if verbose:
            _print_record(rec)
        records.append(rec)
    return records


def _print_record(rec: dict) -> None:
    if rec["status"] == "skipped":
        print(f"[SKIP] {rec['arch']} x {rec['shape']} ({rec['mesh']}): {rec['reason']}")
        return
    if rec["status"] == "error":
        print(f"[FAIL] {rec['arch']} x {rec['shape']} {rec['plan']} ({rec['mesh']}): "
              f"{rec['error']}")
        return
    r, m, c = rec["roofline"], rec["memory"], rec["collectives"]
    print(f"[ OK ] {rec['arch']:22s} {rec['shape']:12s} {rec['plan']:12s} {rec['mesh']:8s} "
          f"call={rec['compile_s']:6.1f}s args/rank={m['argument_bytes'] / 2**30:8.3f}GiB "
          f"gathered/rank={c['total'] / 2**30:8.3f}GiB peak=not measured "
          f"C={r['compute_s']:.3e}s M={r['memory_s']:.3e}s X={r['collective_s']:.3e}s "
          f"dom={r['dominant']:10s} useful={r['useful_flops_ratio']:.2f}")


def build_parser() -> argparse.ArgumentParser:
    from repro_torch.optim import INNER_OPTIMIZERS

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, choices=list(ASSIGNED_ARCHS) + list(LADDER))
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true", help="every arch x shape")
    ap.add_argument("--plan", default=None, help="only this plan (train_step/sync_step/...)")
    ap.add_argument("--inner", default="muon", choices=list(INNER_OPTIMIZERS))
    ap.add_argument("--rounds-per-dispatch", type=int, default=4)
    ap.add_argument("--compression", default="none", choices=["none", "topk", "quant"])
    ap.add_argument("--bits", type=int, default=4)
    ap.add_argument("--out", default="results/dryrun_torch")
    return ap


def main() -> None:
    args = build_parser().parse_args()
    archs = list(ASSIGNED_ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if (args.both_meshes or args.all) else [args.multi_pod]
    os.makedirs(args.out, exist_ok=True)
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}__{shape}__{'2x16x16' if mp else '16x16'}__{args.inner}"
                if args.compression == "quant":
                    tag += f"__quant{args.bits}"
                elif args.compression == "topk":
                    tag += "__topk"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path):
                    print(f"[CACHED] {tag}")
                    continue
                recs = run_one(arch, shape, mp, plan_filter=args.plan, inner_name=args.inner,
                               rounds_per_dispatch=args.rounds_per_dispatch,
                               compression=args.compression, bits=args.bits)
                with open(path, "w") as f:
                    json.dump(recs, f, indent=2)


if __name__ == "__main__":
    torch.set_num_threads(1)
    main()
