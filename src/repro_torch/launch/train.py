"""Training driver (port of ``repro/launch/train.py``): MuLoCo / DiLoCo
rounds of a dense LM on the synthetic Markov stream, on one card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --inner muon --outer nesterov --workers 2 --sync-interval 4 --rounds 3 \
        --seq-len 1024 --batch-per-worker 8 --outer-kernel --seed 0 --out results/t

The parser keeps the reference's flags and defaults, with two changes:
``--attn-impl`` and ``--ns-impl`` default to ``pallas`` (on the card the
port's paths launch the hand-written kernels), and ``--device`` (default
``cuda``) picks the card or, for tests, the CPU, where every kernel runs as
its plain PyTorch version. Weights are random, made from ``--seed``.

Flags of features later slices bring raise ``NotImplementedError`` naming
ROADMAP.md. ``--rounds-per-dispatch`` is accepted: the port runs rounds one
at a time, and since the reference makes every dividing R the same
arithmetic this changes no number; the telemetry line reports
``rounds_per_dispatch=1``, what the port did. ``--autotune`` and the
attention block flags are accepted and change nothing here: the Hopper
kernels tile themselves and the result does not depend on the blocks.
"""
from __future__ import annotations

import argparse
import csv
import math
import os
import time

import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.core.diloco import CompressionConfig, DiLoCoConfig
from repro_torch.data import DataConfig, MarkovStream, batches_for_round
from repro_torch.engine import TrainEngine, run_rounds
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


def check_ported_flags(args) -> None:
    """Raise for the flags of features that later slices of the port bring."""
    deferred = [
        ("--compression", args.compression != "none", 3),
        ("--error-feedback", args.error_feedback, 3),
        ("--streaming", args.streaming > 1, 3),
        ("--resume", args.resume is not None, 4),
        ("--checkpoint-every", bool(args.checkpoint_every), 4),
        ("--checkpoint-in-program", args.checkpoint_in_program, 4),
        ("--health-sentinel", args.health_sentinel == "on", 4),
        ("--drop-prob", args.drop_prob > 0, 4),
        ("--drop-schedule", bool(args.drop_schedule), 4),
        ("--sync-delay", bool(args.sync_delay), 4),
        ("--inject-nan-round", args.inject_nan_round is not None, 4),
        ("--inject-spike-round", args.inject_spike_round is not None, 4),
        ("--inject-kill-round", args.inject_kill_round is not None, 4),
        ("--mesh", args.mesh is not None, 5),
    ]
    for flag, used, slice_no in deferred:
        if used:
            raise NotImplementedError(f"{flag} is not ported to repro_torch yet: "
                                      f"ROADMAP.md, Queue 1, Slice {slice_no}")


def make_diloco_cfg(args) -> DiLoCoConfig:
    return DiLoCoConfig(
        n_workers=args.workers, sync_interval=args.sync_interval, inner_name=args.inner,
        outer_name=args.outer, outer_lr=args.outer_lr, outer_momentum=args.outer_momentum,
        compression=CompressionConfig(kind=args.compression,
                                      error_feedback=args.error_feedback),
        streaming_partitions=args.streaming, ns_impl=args.ns_impl,
        outer_kernel=args.outer_kernel, sync_delay=args.sync_delay)


def train(args) -> dict:
    check_ported_flags(args)
    device = torch.device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    seq_len = args.seq_len or cfg.max_seq_len or 128
    cfg = cfg.replace(
        max_seq_len=seq_len,
        sliding_window=min(cfg.sliding_window, seq_len) if cfg.sliding_window else 0,
        attn_impl=args.attn_impl)
    model = build_model(cfg)

    dcfg = make_diloco_cfg(args)
    total_steps = args.rounds * args.sync_interval
    icfg = OptimizerConfig(
        lr=args.lr, weight_decay=args.weight_decay, schedule=args.schedule,
        warmup_steps=max(total_steps // 100, 5), total_steps=total_steps,
        ns_period=args.ns_period)
    engine = TrainEngine(model, dcfg, icfg)
    state = engine.init(torch.Generator(device=device).manual_seed(args.seed), device)

    data = MarkovStream(DataConfig(
        vocab=cfg.vocab, seq_len=cfg.max_seq_len, batch_per_worker=args.batch_per_worker,
        n_workers=dcfg.n_workers, seed=args.seed), device)
    eval_data = MarkovStream(DataConfig(
        vocab=cfg.vocab, seq_len=cfg.max_seq_len, batch_per_worker=args.batch_per_worker,
        n_workers=1, seed=args.seed + 10_000), device)

    def eval_batches_for(r0, n):
        return {k: v[:, 0] for k, v in eval_data.batch_stack(r0, n).items()}

    os.makedirs(args.out, exist_ok=True)
    losses, steps, history = [], [], []
    telemetry: dict = {}
    t_start = time.time()
    with open(os.path.join(args.out, "metrics.csv"), "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(HEADER)

        def on_round(rec):
            losses.append(rec["eval_loss"])
            steps.append(rec["step"])
            history.append(rec)
            writer.writerow([rec["round"], rec["step"], f"{rec['train_loss']:.9g}",
                             f"{rec['eval_loss']:.9g}", f"{rec['comm_bytes']:.0f}",
                             f"{rec['active_workers']:.0f}", f"{rec['staleness']:.0f}",
                             "0", telemetry.get("rollbacks", 0),
                             f"{time.time() - t_start:.1f}"])
            f.flush()
            if args.verbose:
                print(f"round {rec['round']:4d} step {rec['step']:6d} "
                      f"train {rec['train_loss']:.4f} eval {rec['eval_loss']:.4f} "
                      f"comm {rec['comm_bytes']:.2e}B active {rec['active_workers']:.0f} "
                      f"wall {rec['wall_s']:.3f}s")

        state, _ = run_rounds(engine, state,
                              lambda r: batches_for_round(data, r, dcfg.sync_interval),
                              args.rounds, eval_batches_for=eval_batches_for,
                              on_round=on_round, telemetry=telemetry)

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
                    help="accepted; the port runs one round per dispatch (every "
                         "dividing R is the same arithmetic)")
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
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--blockwise-threshold", type=int, default=None)
    ap.add_argument("--attn-block-q", type=int, default=None)
    ap.add_argument("--attn-block-kv", type=int, default=None)
    ap.add_argument("--autotune", default="on", choices=["on", "off"])
    ap.add_argument("--autotune-table", default=None)
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
