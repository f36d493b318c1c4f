#!/usr/bin/env python3
"""The mesh on one card per rank (NCCL), against one process.

    python3 tools/mesh_probe.py [--ranks 4] [--cases 4x1x1,2x2x1] [--label NAME]
        [--fp32] [training flags ...]

Needs as many cards as ranks (four H100s on one host). For each case it starts
``torchrun`` with one rank per card, each rank this script with ``--child``:
the rank takes NCCL on ``cuda:{local_rank}``, trains ``chip_smoke.MESH_TRAIN``
with the case's mesh and worker count through the CLI entry point, and rank
0 saves the per-round records, the gathered outer params and the bytes each
rank received (``launch/mesh.RECEIVED``; ``STAGED`` stays empty: NCCL moves
CUDA tensors itself). The parent then runs the same command in one process
on ``cuda:0`` (eager; first, so that the ranks find every library built)
and compares:

* ``4x1x1`` with four workers, one a rank: the losses, comm_bytes and every
  outer-param leaf bitwise (each rank runs its worker's shapes as the one
  process does);
* ``2x2x1`` with two workers, each worker's batch split over 'data': its
  gradients averaged there sum in another order, so the losses are held at
  atol 2e-5 + rtol 1e-4 (the port's round parity tolerance) and the outer
  params' gaps are printed: the largest, where, and the share of entries
  apart;
* ``1x4`` and ``2x1x2`` with two workers, each worker split over 'model'
  (tensor parallelism, ``core/collectives.py``: a dense LM whose
  heads, kv heads and widths divide 'model', e.g. ``--arch paper-416m``),
  on one rank per card: held and printed as ``2x2x1``, with rank 0's peak
  memory and the bytes each rank summed over 'model'.

Training flags after the probe's own replace ``MESH_TRAIN``'s (argparse keeps
the last value: ``--compression none``, ``--inner adamw``); ``--fp32`` runs
the model's compute in fp32 (``ModelConfig.dtype``; the flash kernels take
their fp32 sweeps) in the ranks and in the one process alike. ``--label``
names the run's record, ``build/mesh_probe/<label>.json``, also printed as
the last line. ``--variant`` lays the ranks' compute out otherwise, to hold
a layout beside its alternative on the same cases: ``whole_worker`` keeps
each worker whole on every 'model' rank (no tensor parallelism),
``ns_whole`` runs Newton-Schulz's stacks whole on every 'data' rank
(``ns_axes=()``, where NCCL would split them).

Prints the card line of ``nvidia-smi`` and each case's round walls and
tokens/s beside the one-process run's.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import MESH_TRAIN, free_port, replace_flags  # noqa: E402

OUT = ROOT / "build" / "mesh_probe"
CASES = {"4x1x1": 4, "2x2x1": 2, "1x4": 2, "2x1x2": 2}  # mesh -> workers


def case_argv(mesh: str, workers: int, extra: list) -> list:
    return replace_flags(MESH_TRAIN, mesh=mesh, workers=workers, out=OUT / mesh) + list(extra)


def use_fp32() -> None:
    """Every config the training CLI builds computes in fp32."""
    from repro_torch.launch import train as train_mod

    get = train_mod.get_config
    train_mod.get_config = lambda name: get(name).replace(dtype="float32")


def use_variant(variant: str) -> None:
    """The ranks' compute laid out as ``variant`` says (``default``: the
    trainer's own layout)."""
    import dataclasses

    from repro_torch.launch import sharding, steps

    if variant == "whole_worker":
        steps.tp_compute = lambda cfg, mesh: (False, "the probe's whole-worker variant")
    elif variant == "ns_whole":
        specs = sharding.kernel_specs
        sharding.kernel_specs = lambda *a, **kw: dataclasses.replace(specs(*a, **kw), ns_axes=())
    elif variant != "default":
        raise SystemExit(f"mesh_probe: --variant {variant}: default, whole_worker or ns_whole")


def child(mesh: str, extra: list, fp32: bool, variant: str) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.train import build_parser, train
    from repro_torch.utils.tree import tree_leaves_with_paths

    if fp32:
        use_fp32()
    use_variant(variant)
    torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    dist.init_process_group("nccl", init_method="env://")
    torch.cuda.reset_peak_memory_stats()
    out = train(build_parser().parse_args(case_argv(mesh, CASES[mesh], extra)))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    whole = out["engine"].whole_state(out["state"])
    torch.cuda.synchronize()
    if dist.get_rank() == 0:
        torch.save({"history": out["history"],
                    "outer_params": {p: t.cpu() for p, t in
                                     tree_leaves_with_paths(whole["outer_params"])},
                    "received": dict(mesh_mod.RECEIVED), "staged": dict(mesh_mod.STAGED),
                    "backend": dist.get_backend(), "peak_gb": peak_gb,
                    "tp": out["engine"].model_group is not None}, OUT / f"{mesh}.pt")
    dist.barrier()
    dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0], allow_abbrev=False)
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--label", default="default")
    ap.add_argument("--fp32", action="store_true")
    ap.add_argument("--variant", default="default")
    ap.add_argument("--child", default=None)
    args, extra = ap.parse_known_args()
    if args.child:
        child(args.child, extra, args.fp32, args.variant)
        return 0
    import torch

    if torch.cuda.device_count() < args.ranks:
        raise SystemExit(f"mesh_probe: {args.ranks} ranks need {args.ranks} cards, "
                         f"found {torch.cuda.device_count()}")
    from repro_torch.launch.train import build_parser, train
    from repro_torch.utils.tree import tree_leaves_with_paths

    if args.fp32:
        use_fp32()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[{args.label}] cards (nvidia-smi name, power.limit):\n{smi}\n"
          f"[{args.label}] training flags added: {extra}; fp32 compute: {args.fp32}; "
          f"variant: {args.variant}")
    OUT.mkdir(parents=True, exist_ok=True)
    failed, record = [], {"label": args.label, "extra": extra, "fp32": args.fp32, "card": smi,
                          "variant": args.variant}
    for mesh in args.cases.split(","):
        workers = CASES[mesh]
        # the one-process run first: it builds every library the ranks load
        # (each rank would wait on the build's file lock otherwise)
        argv = [a for a in case_argv(mesh, workers, extra) if a not in ("--mesh", mesh)]
        parsed = build_parser().parse_args(argv)
        tokens = parsed.batch_per_worker * parsed.sync_interval * parsed.seq_len  # a worker
        torch.cuda.reset_peak_memory_stats()
        one = train(parsed, capture=False)
        one_peak = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
                              str(math.prod(int(d) for d in mesh.split("x"))), "--master-port",
                              str(free_port()), str(Path(__file__).resolve()), "--child", mesh,
                              "--variant", args.variant,
                              *(["--fp32"] if args.fp32 else []), *extra],
                             cwd=ROOT, capture_output=True, text=True, timeout=900,
                             env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
        if res.returncode:
            print(f"[{mesh}] torchrun exited {res.returncode}\n{res.stdout[-3000:]}\n"
                  f"{res.stderr[-5000:]}")
            failed.append(mesh)
            continue
        got = torch.load(OUT / f"{mesh}.pt")
        ref = {p: t.cpu() for p, t in tree_leaves_with_paths(one["state"]["outer_params"])}
        gaps = {}
        for p, t in got["outer_params"].items():
            if not torch.equal(ref[p], t):
                d = (ref[p].double() - t.double()).abs()
                gaps[p] = {"max": d.max().item(), "apart": (d > 0).double().mean().item(),
                           "max_rel": (d / ref[p].double().abs().clamp_min(1e-30)).max().item()}
        losses = [(a["train_loss"], b["train_loss"], a["eval_loss"], b["eval_loss"])
                  for a, b in zip(one["history"], got["history"])]
        same = all(a["comm_bytes"] == b["comm_bytes"] for a, b in zip(one["history"],
                                                                      got["history"]))
        bitwise = not gaps and all(t1 == t2 and e1 == e2 for t1, t2, e1, e2 in losses)
        close = all(abs(x - y) <= 2e-5 + 1e-4 * abs(x) for t in losses for x, y in
                    (t[:2], t[2:]))
        walls = [r["wall_s"] for r in got["history"]]
        one_walls = [r["wall_s"] for r in one["history"]]
        largest = max(gaps.items(), key=lambda kv: kv[1]["max"]) if gaps else None
        print(f"[{args.label} {mesh}] {workers} workers on {mesh} ({got['backend']}), torchrun "
              f"{time.perf_counter() - t0:.1f} s; losses (train one process, mesh, eval one "
              f"process, mesh) {losses}; within atol 2e-5 + rtol 1e-4: {close}; comm_bytes "
              f"equal {same}; outer leaves not bitwise {len(gaps)} of {len(ref)}"
              f"{', largest ' + str(largest) if largest else ''}; every gap {gaps}; "
              f"round walls {[round(w, 3) for w in walls]} s, "
              f"{workers * tokens / walls[-1]:.1f} tok/s in the last round against one "
              f"process (eager) {[round(w, 3) for w in one_walls]} s, "
              f"{workers * tokens / one_walls[-1]:.1f}; bytes received a rank {got['received']}, "
              f"staged {got['staged']}; split over 'model': {got['tp']}; peak memory rank 0 "
              f"{got['peak_gb']:.2f} GB, one process {one_peak:.2f} GB")
        record[mesh] = {"losses": losses, "close": close, "comm_bytes_equal": same,
                        "bitwise": bitwise, "gaps": gaps, "walls": walls,
                        "one_walls": one_walls, "received": got["received"], "tp": got["tp"],
                        "peak_gb": got["peak_gb"], "one_peak_gb": one_peak}
        ok = (bitwise if mesh == "4x1x1" else close) and same
        if not ok:
            failed.append(mesh)
        del one
        torch.cuda.empty_cache()
    (OUT / f"{args.label}.json").write_text(json.dumps(record, indent=1))
    print(f"mesh_probe [{args.label}]: {'FAILED ' + str(failed) if failed else 'every case held'}")
    print(json.dumps(record))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
