"""Training driver (port of ``repro/launch/train.py``): MuLoCo / DiLoCo
rounds of a dense LM on the synthetic Markov stream, on one card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --inner muon --outer nesterov --workers 2 --sync-interval 4 --rounds 3 \
        --seq-len 1024 --batch-per-worker 8 --outer-kernel --seed 0 --out results/t

Add ``--compression quant --bits 2 --error-feedback`` for the paper's
compressed variant (2-bit quantized pseudogradients with error feedback),
and ``--rowwise --streaming 2`` for row-wise quantization and a streaming
sync of two partitions.

The parser keeps the reference's flags and defaults, with two changes:
``--attn-impl`` and ``--ns-impl`` default to ``pallas`` (on the card the
port's paths launch the hand-written kernels), and ``--device`` (default
``cuda``) picks the card or, for tests, the CPU, where every kernel runs as
its plain PyTorch version. Weights are random, made from ``--seed``.

``--rounds-per-dispatch R`` (default ``auto``: the whole run when
unmeasured, clamped to divide the run and the checkpoint cadence) runs R
rounds per dispatch; on the card each round is a replay of one captured
CUDA graph (:mod:`repro_torch.engine.engine`), and every dividing R is the
same arithmetic, bit for bit. Metrics drain late (``run_rounds``), and the
telemetry line reports what ran.

Crash safety as in the reference: ``--checkpoint-every N`` writes
checksummed ``ckpt_<round>.npz`` files (``--keep-checkpoints``,
``--checkpoint-in-program``), ``--resume auto`` restarts from the newest
valid one and rewrites metrics.csv up to it, ``--health-sentinel on`` rolls
a flagged round back to the last checkpoint and skips it,
``--inject-{nan,spike,kill}-round`` injects faults, and SIGTERM / SIGINT
drain in-flight rounds and write a resumable checkpoint.

Elastic execution as in the reference: ``--drop-schedule 'round:worker;...'``
and ``--drop-prob p`` (with ``--drop-seed``) drop workers per round (the
masks of ``core/faults.FaultPlan``), ``--sync-delay d`` applies each
pseudogradient d rounds late; metrics.csv's ``active_workers`` and
``staleness`` columns carry them.

``--mesh PxDxM`` (or ``DxM``) trains on a mesh of ranks with the
reference's axes (pod, data, model): the K workers are spread over 'pod',
each worker's batch over 'data' (``TrainEngine(mesh=...)``). Launch it with
one process per rank, ``torchrun --nproc-per-node N -m
repro_torch.launch.train --mesh ...`` with N the mesh's size (a mismatch
raises a ValueError naming both); a single process with no launcher is a
world of one. Each rank places itself on ``cuda:{local_rank % cards}``
(``--device cpu``: the CPU); the backend is NCCL when every rank has a
card of its own and gloo otherwise (``--device cpu``, or two ranks sharing
one card). The state is made whole on every rank from ``--seed`` and then
placed by the reference's specs, so a mesh run starts from the bits of the
one-process run. Rank 0 writes ``metrics.csv`` and prints. Every flag of the
one-process run holds on a mesh: streaming, elastic drops and a sync delay
run in the mesh round; a checkpoint is the whole state, gathered to rank 0
and written there (the one-process run's file, byte for byte);
``--resume`` has rank 0 pick the file and every rank load it, laid out
again by the state's specs (and asserted so); the health sentinel's
rollback, its LR backoff and SIGTERM's drain happen on every rank at the
same round (the flags are agreed by a max over the ranks); ``--inject-*``
poison the global worker the one-process run poisons, on the ranks that
hold it, and a kill takes every rank down after rank 0's row is out.
``--blockwise-threshold`` and ``--attn-block-q/kv`` set
the plain path's (``--attn-impl xla``) blockwise attention as in the
reference. ``--autotune on`` (the default) consults the committed table
``src/repro_torch/kernels/autotune_table.json`` (or ``--autotune-table``),
as the reference does: its attention knobs for the model's shape, then the
explicit flags above over them; on the card the Newton–Schulz and quantize
calls launch the build variant the table names for their shapes
(:mod:`repro_torch.kernels.autotune`). ``--autotune off`` gives every
default. Every variant is bitwise the default, so the two runs' losses and
states are the same bits.
"""
from __future__ import annotations

import argparse
import csv
import dataclasses
import math
import os
import signal
import time

import numpy as np
import torch

from repro_torch.checkpoint import load_checkpoint, load_latest_valid, save_round_checkpoint
from repro_torch.configs import get_config, reduce_config
from repro_torch.core import CompressionConfig, DiLoCoConfig, HealthConfig
from repro_torch.core.faults import CrashPlan, FaultPlan, parse_drop_schedule
from repro_torch.data import DataConfig, MarkovStream, batches_for_round, batches_for_span
from repro_torch.engine import RecoveryPolicy, TrainEngine, run_rounds
from repro_torch.models import build_model
from repro_torch.optim import INNER_OPTIMIZERS, OUTER_OPTIMIZERS, OptimizerConfig

HEADER = ["round", "step", "train_loss", "eval_loss", "comm_bytes", "active_workers",
          "staleness", "health", "rollbacks", "wall_s"]


def smoothed_eval_loss(losses: list[float], steps: list[int], H: int, alpha: float = 0.2) -> float:
    """Paper §5 / App. F: EMA of the eval losses over sync points."""
    s = None
    prev_t = None
    for loss, t in zip(losses, steps):
        if t % H:
            continue
        if s is None:
            s, prev_t = loss, t
            continue
        a = 1.0 - math.exp(-alpha * (t - prev_t) / H)
        s = a * loss + (1.0 - a) * s
        prev_t = t
    return s if s is not None else (losses[-1] if losses else float("nan"))


def parse_mesh(spec: str) -> dict[str, int]:
    """'DxM' or 'PxDxM' -> the mesh's axis sizes (P -> 'pod')."""
    try:
        dims = [int(d) for d in spec.lower().split("x")]
    except ValueError:
        dims = []
    if len(dims) == 2:
        return {"data": dims[0], "model": dims[1]}
    if len(dims) == 3:
        return {"pod": dims[0], "data": dims[1], "model": dims[2]}
    raise SystemExit(f"--mesh {spec!r}: expected DxM or PxDxM")


def start_mesh(args):
    """``(mesh, device, rank, created)``: the process group of this rank
    (``torchrun``'s environment; a world of one without it) and the debug
    mesh ``args.mesh`` names over it. ``created`` is True when this call
    initialised the group (the caller destroys it)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh

    sizes = parse_mesh(args.mesh)
    n = math.prod(sizes.values())
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    if n != world:
        raise ValueError(f"--mesh {args.mesh} has {n} ranks, but the world has {world} "
                         f"processes (launch with torchrun --nproc-per-node {n})")
    on_card = torch.device(args.device).type == "cuda"
    if on_card:
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
        backend = "nccl" if local_world <= torch.cuda.device_count() else "gloo"
    else:
        device, backend = torch.device("cpu"), "gloo"
    created = not dist.is_initialized()
    if created:
        if "MASTER_ADDR" in os.environ:
            dist.init_process_group(backend, init_method="env://", world_size=world, rank=rank)
        else:  # a world of one, no launcher
            dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0)
    mesh = make_debug_mesh(sizes.get("data", 1), sizes.get("model", 1), sizes.get("pod", 0),
                           device_type="cuda" if on_card else "cpu")
    return mesh, device, rank, created


def make_diloco_cfg(args) -> DiLoCoConfig:
    comp = CompressionConfig(
        kind=args.compression, bits=args.bits, topk_frac=args.topk_frac,
        quant_mode=args.quant_mode, rowwise=args.rowwise,
        error_feedback=args.error_feedback,
        collective="gather" if args.compression == "topk" else "a2a_rs_ag")
    # a drop knob switches elastic execution on: the participation mask only
    # enters the state (and the masked program the rounds) when asked for
    elastic = args.drop_prob > 0 or bool(args.drop_schedule)
    return DiLoCoConfig(
        n_workers=args.workers, sync_interval=args.sync_interval, inner_name=args.inner,
        outer_name=args.outer, outer_lr=args.outer_lr, outer_momentum=args.outer_momentum,
        compression=comp, streaming_partitions=args.streaming, ns_impl=args.ns_impl,
        outer_kernel=args.outer_kernel, elastic=elastic, sync_delay=args.sync_delay,
        health=HealthConfig(enabled=args.health_sentinel == "on",
                            spike_factor=args.health_spike_factor,
                            warmup_rounds=args.health_warmup))


def make_fault_plan(args, n_workers: int) -> FaultPlan | None:
    """The host-side participation-mask generator, or None for lockstep."""
    schedule = parse_drop_schedule(args.drop_schedule) if args.drop_schedule else None
    plan = FaultPlan(n_workers=n_workers, drop_prob=args.drop_prob,
                     schedule=schedule, seed=args.drop_seed)
    return None if plan.is_trivial else plan


def resolve_blocks(cfg, args, seq_len: int, device):
    """The reference's block-size resolution order: the autotune table
    (``configure`` routes every later lookup; its attention entry for this
    shape when on) < the explicit CLI overrides (None = not passed)."""
    from repro_torch.kernels.autotune import _backend, configure, tuned_model_config

    configure(enabled=args.autotune == "on", table_path=args.autotune_table)
    if args.autotune == "on":
        cfg = tuned_model_config(cfg, seq_len, _backend(device))
    overrides = {k: v for k, v in (("blockwise_threshold", args.blockwise_threshold),
                                   ("attn_block_q", args.attn_block_q),
                                   ("attn_block_kv", args.attn_block_kv)) if v is not None}
    return cfg.replace(**overrides) if overrides else cfg


def train(args, *, capture: bool | None = None) -> dict:
    """Run the command ``args`` (``build_parser``'s namespace). ``capture``
    is ``TrainEngine``'s (default: capture on a CUDA device); ``False``
    keeps the eager path on the card, for equality checks."""
    if args.mesh is None:
        return _train(args, torch.device(args.device), capture=capture)
    import contextlib

    import torch.distributed as dist

    mesh, device, rank, created = start_mesh(args)
    try:
        quiet = contextlib.nullcontext() if rank == 0 else contextlib.redirect_stdout(
            open(os.devnull, "w"))
        with quiet:
            return _train(args, device, capture=capture, mesh=mesh, rank=rank)
    finally:
        if created:
            dist.destroy_process_group()


def _train(args, device: torch.device, *, capture: bool | None = None, mesh=None,
           rank: int = 0) -> dict:
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    seq_len = args.seq_len or cfg.max_seq_len or 128
    cfg = cfg.replace(
        max_seq_len=seq_len,
        sliding_window=min(cfg.sliding_window, seq_len) if cfg.sliding_window else 0,
        attn_impl=args.attn_impl)
    cfg = resolve_blocks(cfg, args, seq_len, device)
    model = build_model(cfg)

    dcfg = make_diloco_cfg(args)
    total_steps = args.rounds * args.sync_interval
    icfg = OptimizerConfig(
        lr=args.lr, weight_decay=args.weight_decay, schedule=args.schedule,
        warmup_steps=max(total_steps // 100, 5), total_steps=total_steps,
        ns_period=args.ns_period)
    engine = TrainEngine(model, dcfg, icfg, capture=capture, mesh=mesh)
    state = engine.init(torch.Generator(device=device).manual_seed(args.seed), device)
    template = state  # paths and devices of a checkpoint's leaves
    # on a mesh a loaded state is laid out again by the state's specs
    place = ({} if mesh is None else
             {"shardings": engine.state_shardings(), "mesh": mesh})

    start_round, resumed_from = 0, None
    if args.resume == "auto":
        got = load_latest_valid(args.out, template, device=device, **place)
        if got is not None:
            state, start_round, resumed_from = got
    elif args.resume and os.path.exists(args.resume):
        state, start_round = load_checkpoint(args.resume, template, device=device, **place)
        resumed_from = args.resume
    if resumed_from is not None:
        if mesh is not None:
            engine.check_placement(state)
        print(f"resumed from {resumed_from} at round {start_round}")
        print(f"resume telemetry: resumed_from={os.path.basename(resumed_from)} "
              f"start_round={start_round}")

    data = MarkovStream(DataConfig(
        vocab=cfg.vocab, seq_len=cfg.max_seq_len, batch_per_worker=args.batch_per_worker,
        n_workers=dcfg.n_workers, seed=args.seed), device)
    eval_data = MarkovStream(DataConfig(
        vocab=cfg.vocab, seq_len=cfg.max_seq_len, batch_per_worker=args.batch_per_worker,
        n_workers=1, seed=args.seed + 10_000), device)

    def eval_batches_for(r0, n):
        return {k: v[:, 0] for k, v in eval_data.batch_stack(r0, n).items()}

    os.makedirs(args.out, exist_ok=True)
    csv_path = os.path.join(args.out, "metrics.csv") if rank == 0 else os.devnull
    losses, steps, history = [], [], []
    # Resume: keep the killed run's rows before start_round (their eval
    # losses, logged at %.9g, round-trip through float32 exactly, so the
    # smoothed eval continues from the same history) and drop the rows of
    # rounds whose state was lost.
    prior_rows: list[list[str]] = []
    if start_round > 0 and rank == 0 and os.path.exists(csv_path):
        with open(csv_path, newline="") as f:
            prior_rows = [row for row in csv.reader(f)
                          if row and row[0].isdigit() and int(row[0]) < start_round]
        for row in prior_rows:
            losses.append(float(np.float32(row[3])))
            steps.append(int(row[1]))
    telemetry: dict = {}
    fault_plan = make_fault_plan(args, dcfg.n_workers)
    crash = CrashPlan(nan_round=args.inject_nan_round, spike_round=args.inject_spike_round,
                      kill_round=args.inject_kill_round)
    t_start = time.time()
    with open(csv_path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(HEADER)
        writer.writerows(prior_rows)
        f.flush()

        def on_round(rec):
            losses.append(rec["eval_loss"])
            steps.append(rec["step"])
            history.append(rec)
            writer.writerow([rec["round"], rec["step"], f"{rec['train_loss']:.9g}",
                             f"{rec['eval_loss']:.9g}", f"{rec['comm_bytes']:.0f}",
                             f"{rec['active_workers']:.0f}", f"{rec['staleness']:.0f}",
                             f"{rec.get('health', 0.0):.0f}", telemetry.get("rollbacks", 0),
                             f"{time.time() - t_start:.1f}"])
            f.flush()
            if args.verbose:
                print(f"round {rec['round']:4d} step {rec['step']:6d} "
                      f"train {rec['train_loss']:.4f} eval {rec['eval_loss']:.4f} "
                      f"comm {rec['comm_bytes']:.2e}B active {rec['active_workers']:.0f} "
                      f"wall {rec['wall_s']:.3f}s")
            # the kill fires after the row is out: a real crash's trail on disk
            # (on a mesh every rank dies once rank 0's row is out)
            if mesh is not None and rec["round"] == crash.kill_round:
                import torch.distributed as dist

                dist.barrier()
            crash.maybe_kill(rec["round"])

        def on_state(r, st):  # on a mesh: rank 0's whole state, None elsewhere
            if st is not None:
                save_round_checkpoint(args.out, st, r + 1, keep=args.keep_checkpoints)

        recovery = None
        if dcfg.health.enabled and args.checkpoint_every:
            def restore():
                got = load_latest_valid(args.out, template, device=device, **place)
                return None if got is None else (got[0], got[1])

            def scale_lr(scale):
                return TrainEngine(model, dcfg, dataclasses.replace(icfg, lr=args.lr * scale),
                                   capture=capture, mesh=mesh, kernel_parts=engine.kernel_parts)

            recovery = RecoveryPolicy(restore=restore, max_rollbacks=args.health_max_rollbacks,
                                      scale_lr=scale_lr)
            first = start_round == 0 and not os.path.exists(os.path.join(args.out, "ckpt_0.npz"))
            if engine.agree_max([float(first)])[0]:
                # a round-0 fault needs something to roll back to
                on_state(-1, engine.checkpoint_state(state))

        # a poisoning injection edits the state at a dispatch boundary; on a
        # mesh it edits the rank's compute layout, where its workers are
        rpd = 1 if crash.needs_single_round_dispatch else args.rounds_per_dispatch

        def inject(r0, n, batches, st):
            if mesh is None:
                return crash.apply(r0, n, batches, st)
            return crash.apply(r0, n, batches, engine.compute_state(st),
                               held=engine.held_workers())
        stop = {"flag": False}

        def _graceful(signum, frame):
            stop["flag"] = True
            print(f"signal {signum}: draining in-flight dispatches, then writing a "
                  "resumable checkpoint")

        old_handlers = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                old_handlers[sig] = signal.signal(sig, _graceful)
            except ValueError:  # not the main thread
                pass
        try:
            state, _ = run_rounds(
                engine, state, lambda r: batches_for_round(data, r, dcfg.sync_interval),
                args.rounds, start=start_round, rounds_per_dispatch=rpd,
                span_batches_for=lambda r0, n: batches_for_span(data, r0, dcfg.sync_interval, n),
                eval_batches_for=eval_batches_for,
                participation_for=fault_plan.masks if fault_plan is not None else None,
                on_round=on_round,
                on_state=on_state if args.checkpoint_every else None,
                on_state_every=args.checkpoint_every,
                checkpoint_in_program=args.checkpoint_in_program, telemetry=telemetry,
                recovery=recovery, should_stop=lambda: stop["flag"],
                inject=None if crash.is_trivial else inject)
        finally:
            for sig, handler in old_handlers.items():
                signal.signal(sig, handler)

    if telemetry.get("preempted"):
        whole = engine.checkpoint_state(state)  # every rank; rank 0 writes
        if whole is not None:
            done = int(whole["round"])
            path = save_round_checkpoint(args.out, whole, done, keep=args.keep_checkpoints)
            print(f"preempted after round {done - 1}: wrote {os.path.basename(path)}; "
                  "resume with --resume auto")
        del whole
    if engine.capture_s and args.verbose:
        print(f"captured round program: warm-up rounds {engine.warmup_s} s, captures "
              f"{engine.capture_s} s, {engine.replays} replays")
    print(f"dispatch telemetry: dispatches={telemetry.get('dispatches')} "
          f"rounds_per_dispatch={telemetry.get('rounds_per_dispatch')} "
          f"in_program_checkpoints={telemetry.get('in_program_checkpoints')} "
          f"rollbacks={telemetry.get('rollbacks')} "
          f"skipped_rounds={telemetry.get('skipped_rounds')} "
          f"preempted={telemetry.get('preempted')}")
    final = smoothed_eval_loss(losses, steps, dcfg.sync_interval)
    print(f"final smoothed eval loss: {final:.4f} "
          f"(floor={data.entropy_floor_nats():.4f} nats)")
    return {"final_loss": final, "losses": losses, "steps": steps, "state": state,
            "telemetry": telemetry, "history": history, "model": model, "engine": engine}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true", help="CPU-sized variant")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the kernel path) or 'cpu' (the plain versions)")
    ap.add_argument("--inner", default="muon", choices=list(INNER_OPTIMIZERS))
    ap.add_argument("--outer", default="nesterov", choices=list(OUTER_OPTIMIZERS))
    ap.add_argument("--ns-period", type=int, default=1,
                    help="muon_bp: orthogonalize every b steps (1 = plain Muon)")
    ap.add_argument("--outer-kernel", action="store_true",
                    help="route the outer descent through the fused Hopper kernel")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--sync-interval", type=int, default=6)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--rounds-per-dispatch", type=lambda v: v if v == "auto" else int(v),
                    default="auto",
                    help="rounds per dispatch (R), or 'auto' (the whole run when "
                         "unmeasured); clamped to divide the run and the checkpoint "
                         "cadence; every dividing R is the same arithmetic")
    ap.add_argument("--lr", type=float, default=2e-2)
    ap.add_argument("--weight-decay", type=float, default=1e-4)
    ap.add_argument("--schedule", default="cosine", choices=["cosine", "constant"])
    ap.add_argument("--outer-lr", type=float, default=0.7)
    ap.add_argument("--outer-momentum", type=float, default=0.9)
    ap.add_argument("--batch-per-worker", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=0,
                    help="0 -> the arch config's max_seq_len (128 if unset)")
    ap.add_argument("--compression", default="none", choices=["none", "topk", "quant"])
    ap.add_argument("--bits", type=int, default=4)
    ap.add_argument("--quant-mode", default="linear", choices=["linear", "statistical"])
    ap.add_argument("--rowwise", action="store_true")
    ap.add_argument("--topk-frac", type=float, default=0.1)
    ap.add_argument("--error-feedback", action="store_true")
    ap.add_argument("--streaming", type=int, default=1, help="J partitions")
    ap.add_argument("--sync-delay", type=int, default=0)
    ap.add_argument("--drop-prob", type=float, default=0.0)
    ap.add_argument("--drop-schedule", default=None)
    ap.add_argument("--drop-seed", type=int, default=0)
    ap.add_argument("--ns-impl", default="pallas", choices=["jnp", "pallas"],
                    help="'pallas': Newton-Schulz through the Hopper matmul kernel "
                         "(fp32); 'jnp': the plain bf16 iteration")
    ap.add_argument("--attn-impl", default="pallas", choices=["xla", "pallas"],
                    help="'pallas': the flash-attention kernels; 'xla': plain torch")
    ap.add_argument("--mesh", default=None,
                    help="train on a DxM or PxDxM mesh of ranks (pod = the worker axis); "
                         "one process per rank, under torchrun")
    ap.add_argument("--blockwise-threshold", type=int, default=None)
    ap.add_argument("--attn-block-q", type=int, default=None)
    ap.add_argument("--attn-block-kv", type=int, default=None)
    ap.add_argument("--autotune", default="on", choices=["on", "off"],
                    help="consult the kernel autotune table (bitwise-gated tile variants; "
                         "'off' restores every default)")
    ap.add_argument("--autotune-table", default=None,
                    help="path of the autotune JSON table (default: the committed "
                         "src/repro_torch/kernels/autotune_table.json)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="results/train")
    ap.add_argument("--resume", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--keep-checkpoints", type=int, default=3)
    ap.add_argument("--health-sentinel", default="off", choices=["on", "off"])
    ap.add_argument("--health-spike-factor", type=float, default=3.0)
    ap.add_argument("--health-warmup", type=int, default=3)
    ap.add_argument("--health-max-rollbacks", type=int, default=3)
    ap.add_argument("--inject-nan-round", type=int, default=None)
    ap.add_argument("--inject-spike-round", type=int, default=None)
    ap.add_argument("--inject-kill-round", type=int, default=None)
    ap.add_argument("--checkpoint-in-program", action="store_true")
    ap.add_argument("--verbose", action="store_true")
    return ap


if __name__ == "__main__":
    train(build_parser().parse_args())
