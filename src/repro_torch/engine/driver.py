"""Round driver (port of ``repro/engine/driver.py:run_rounds``).

Runs rounds one at a time through the engine, evaluates the post-sync outer
params on a held-out batch per round, and hands each round's metrics to
``on_round``. Reading a round's losses to host floats waits for the device,
so each record's ``wall_s`` is the round's time ended by the card.

Deferred with their slices (ROADMAP.md): multi-round dispatch, the
in-program checkpoint, checkpoints and recovery (``on_state``,
``recovery``, ``should_stop``, ``inject``) and elastic participation.
"""
from __future__ import annotations

import time
from typing import Any, Callable

Tree = Any


def run_rounds(engine, state: dict, batches_for: Callable[[int], Tree], rounds: int, *,
               start: int = 0,
               eval_batches_for: Callable[[int, int], Tree] | None = None,
               on_round: Callable[[dict], None] | None = None,
               telemetry: dict | None = None) -> tuple[dict, list[dict]]:
    """Run rounds ``start..rounds-1``. ``batches_for(r)`` gives round r's
    [H, K, B, ...] batches; ``eval_batches_for(r0, n)`` (optional) gives
    [n, B, ...] held-out batches, one per round, for the eval loss of the
    post-sync outer params. Returns the final state and per-round records."""
    H = engine.dcfg.sync_interval
    if telemetry is not None:
        telemetry.update(rounds_per_dispatch=1, dispatches=0, in_program_checkpoints=False,
                         rollbacks=0, skipped_rounds=0, lr_scale=1.0, preempted=False)
    history: list[dict] = []
    for r in range(start, rounds):
        t0 = time.perf_counter()
        state, info = engine.step(state, batches_for(r))
        if telemetry is not None:
            telemetry["dispatches"] += 1
        losses = info["loss"].float().cpu()
        rec = {"round": r, "step": (r + 1) * H,
               "train_loss": float(losses.mean()), "train_loss_last": float(losses[-1]),
               "comm_bytes": float(info["comm_bytes"]),
               "active_workers": float(info["active_workers"]),
               "staleness": float(info["staleness"])}
        if eval_batches_for is not None:
            eb = eval_batches_for(r, 1)
            rec["eval_loss"] = float(engine.eval_loss(state["outer_params"],
                                                      {k: v[0] for k, v in eb.items()}))
        rec["wall_s"] = time.perf_counter() - t0
        history.append(rec)
        if on_round is not None:
            on_round(rec)
    return state, history
