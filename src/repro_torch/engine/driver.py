"""Round driver (port of ``repro/engine/driver.py:run_rounds``): R rounds
per dispatch, late metric reads, checkpoints and recovery.

* **R rounds per dispatch**: with ``rounds_per_dispatch=R`` (or
  ``"auto"``) the engine runs R rounds per :meth:`TrainEngine.superstep`
  call, replays of one captured round on the card, with no host read
  between them. R is clamped (:func:`effective_rounds_per_dispatch`) to
  divide the rounds left and the checkpoint cadence.
* **late metric reads**: after each dispatch the driver queues copies of
  its metric buffers into pinned host memory and records an event; it
  reads them only once more than ``max_in_flight`` dispatches are pending,
  so batch generation, CSV writing and logging run while the card works.
  A record's ``wall_s`` is the time between the end of the previous
  dispatch (the run's start for the first) and the end of this one, split
  evenly over its rounds: on the card, read off timing events on the
  card's clock (so a round's wall holds its kernels and any time the card
  waited for the host); on the CPU, between drains on the host clock.
* **checkpoints**: ``on_state(r, state)`` fires every ``on_state_every``
  rounds. Between dispatches (the default) all pending metrics drain first,
  so the CSV never lags a checkpoint. With ``checkpoint_in_program=True`` R
  need not divide the cadence: each flagged round's state is copied out
  inside the dispatch (``TrainEngine._emit_checkpoint``: pinned host
  buffers and an event, no host wait) and written once the dispatch has
  drained; flagged and unflagged rounds run the same arithmetic.
* **elastic runs**: ``participation_for(r0, n)`` gives the [n, K] masks of
  rounds r0..r0+n-1 (``core/faults.FaultPlan.masks``, a pure function of
  the seed and the round, so a resume or a rollback sees the same masks);
  each dispatch gets its own, and the records carry the rounds'
  ``active_workers`` and ``staleness``.
* **crash safety**: with the health sentinel on, each round's flag drains
  with the other metrics; a :class:`RecoveryPolicy` turns a nonzero flag
  into rollback to the last valid checkpoint, a skip past the bad round and
  bounded LR backoff, all on the host. ``should_stop`` (SIGTERM/SIGINT in
  ``launch/train.py``) stops dispatching, drains, and returns a state to
  checkpoint; ``inject`` (``core/faults.CrashPlan.apply``) corrupts chosen
  dispatches.
* **a mesh** (``TrainEngine(mesh=...)``, one process per rank): every rank
  runs this loop in lockstep. A checkpoint is the whole state
  (``engine.checkpoint_state``, a collective every rank takes: rank 0's
  ``on_state`` gets it and every other rank's gets None); the drained
  health flags and the stop flag are each rank's own reading reduced by a
  max over the ranks (``engine.agree_max``), so every rank rolls back,
  skips and stops at the same round; ``restore`` hands back the state laid
  out again.
"""
from __future__ import annotations

import collections
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.engine.recovery import RecoveryPolicy, TrainingAborted
from repro_torch.engine.superstep import STACKED, effective_rounds_per_dispatch

Tree = Any


class _Fault(Exception):
    """A drained health buffer carried a nonzero flag."""

    def __init__(self, round: int, code: int):
        super().__init__(f"health flag {code} at round {round}")
        self.round = round
        self.code = code


def _with_round(state: dict, value: int) -> dict:
    """A state whose round counter is ``value`` (a new tensor; a captured
    engine copies it into its own at the next dispatch)."""
    old = state["round"]
    return {**state, "round": torch.full((), value, dtype=old.dtype, device=old.device)}


def _timing_event():
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event


def _to_host(out: dict) -> tuple[dict, Any]:
    """Start copying a dispatch's metric buffers to the host: pinned
    buffers and a timing event on the card, the tensors themselves on the
    CPU."""
    bufs = {k: v for k, v in out.items() if k in STACKED}
    if not bufs or next(iter(bufs.values())).device.type != "cuda":
        return bufs, None
    host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True).copy_(v, non_blocking=True)
            for k, v in bufs.items()}
    return host, _timing_event()


def run_rounds(engine, state: dict, batches_for: Callable[[int], Tree], rounds: int, *,
               start: int = 0,
               rounds_per_dispatch: int | str = 1,
               span_batches_for: Callable[[int, int], Tree] | None = None,
               eval_batches_for: Callable[[int, int], Tree] | None = None,
               participation_for: Callable[[int, int], Any] | None = None,
               on_round: Callable[[dict], None] | None = None,
               on_state: Callable[[int, Any], None] | None = None,
               on_state_every: int = 1,
               checkpoint_in_program: bool = False,
               host_overhead_s: float | None = None,
               device_round_s: float | None = None,
               telemetry: dict | None = None,
               max_in_flight: int = 2,
               recovery: RecoveryPolicy | None = None,
               should_stop: Callable[[], bool] | None = None,
               inject: Callable[[int, int, Tree, Any], tuple[Tree, Any]] | None = None,
               ) -> tuple[dict, list[dict]]:
    """Run rounds ``start..rounds-1``; returns the final state and the
    per-round records.

    ``batches_for(r)`` gives round r's [H, K, B, ...] batches;
    ``span_batches_for(r0, n)`` (optional) the round-stacked [n, H, K, B,
    ...] batches of rounds r0..r0+n-1 in one call (else the driver stacks
    ``batches_for``). ``eval_batches_for(r0, n)`` (optional) gives [n, B,
    ...] held-out batches; each round's post-sync eval loss is computed
    inside the dispatch. ``participation_for(r0, n)`` (elastic runs) gives
    the [n, K] float32 worker masks of those rounds, on the host.
    ``rounds_per_dispatch`` is an int or ``"auto"``
    (the cost model of :mod:`repro_torch.engine.superstep`, fed
    ``host_overhead_s`` / ``device_round_s`` when measured; the whole span
    when not). ``on_round(record)`` fires per round as a dispatch drains;
    ``on_state``, ``checkpoint_in_program``, ``recovery``, ``should_stop``
    and ``inject`` are the module docstring's. ``telemetry`` (optional) is
    filled with what ran: ``rounds_per_dispatch``, ``dispatches``,
    ``in_program_checkpoints``, ``rollbacks``, ``skipped_rounds``,
    ``lr_scale`` and ``preempted``.
    """
    span = rounds - start
    in_prog_ckpt = checkpoint_in_program and on_state is not None and bool(on_state_every)
    cadence = on_state_every if (on_state is not None and not in_prog_ckpt) else 0
    R0 = effective_rounds_per_dispatch(rounds_per_dispatch, span, cadence, start=start,
                                       host_overhead_s=host_overhead_s,
                                       device_round_s=device_round_s)
    H = engine.dcfg.sync_interval
    pending: collections.deque = collections.deque()
    history: list[dict] = []
    if telemetry is not None:
        telemetry.update(rounds_per_dispatch=R0, dispatches=0,
                         in_program_checkpoints=in_prog_ckpt, rollbacks=0,
                         skipped_rounds=0, lr_scale=1.0, preempted=False)
    ckpt_stash: collections.deque = collections.deque()
    if in_prog_ckpt:
        engine.checkpoint_sink = ckpt_stash.append

    def flush_checkpoints() -> None:
        while ckpt_stash:
            st, event = ckpt_stash.popleft()
            if event is not None:
                event.synchronize()
            on_state(int(st["round"]) - 1, st)

    on_card = state["round"].device.type == "cuda"
    # the end of the previous dispatch: a timing event on the card, else
    # the host clock at the previous drain
    last_end = [_timing_event() if on_card else time.perf_counter()]

    def drain_one() -> None:
        r0, n, host, event = pending.popleft()
        if event is not None:
            event.synchronize()
        hls = host["health"].tolist() if "health" in host else None
        if hls is not None and recovery is not None:  # no rank decides alone
            hls = engine.agree_max(hls)
        if hls is not None and recovery is not None and any(h != 0 for h in hls):
            # record nothing from a poisoned dispatch: every round after the
            # flagged one trained on corrupted state
            bad = next(i for i, h in enumerate(hls) if h != 0)
            raise _Fault(r0 + bad, int(hls[bad]))
        if event is not None:
            wall = last_end[0].elapsed_time(event) / 1e3 / n
            last_end[0] = event
        else:
            now = time.perf_counter()
            wall = (now - last_end[0]) / n
            last_end[0] = now
        losses = host["loss"].reshape(n, -1)
        cols = {k: host[k].tolist() for k in ("comm_bytes", "active_workers", "staleness",
                                             "eval_loss") if k in host}
        for i in range(n):
            rec = {"round": r0 + i, "step": (r0 + i + 1) * H,
                   "train_loss": float(losses[i].mean()),
                   "train_loss_last": float(losses[i, -1])}
            rec.update({k: float(v[i]) for k, v in cols.items()})
            if hls is not None:
                rec["health"] = float(hls[i])
            rec["wall_s"] = wall
            history.append(rec)
            if on_round is not None:
                on_round(rec)

    def stack(bs: list[dict]) -> dict:
        return {k: torch.stack([b[k] for b in bs]) for k in bs[0]}

    rollbacks_left = recovery.max_rollbacks if recovery is not None else 0
    lr_scale = 1.0
    lr_halvings = 0
    r0 = start
    done = False
    while not done:
        try:
            while r0 < rounds:
                if should_stop is not None and engine.agree_max([float(should_stop())])[0]:
                    if telemetry is not None:
                        telemetry["preempted"] = True
                    break
                R = effective_rounds_per_dispatch(R0, rounds - r0, cadence, start=r0)
                batches = (span_batches_for(r0, R) if span_batches_for is not None
                           else stack([batches_for(r0 + i) for i in range(R)]))
                if inject is not None:
                    batches, state = inject(r0, R, batches, state)
                eb = eval_batches_for(r0, R) if eval_batches_for is not None else None
                flags = ([(r0 + i + 1) % on_state_every == 0 for i in range(R)]
                         if in_prog_ckpt else None)
                masks = (None if participation_for is None
                         else np.asarray(participation_for(r0, R), np.float32))
                state, out = engine.superstep(state, batches, eb, participation=masks,
                                              ckpt_flags=flags)
                if telemetry is not None:
                    telemetry["dispatches"] += 1
                # keep the metric buffers only: psi must be freeable now
                pending.append((r0, R, *_to_host(out)))
                del out
                if cadence and (r0 + R) % on_state_every == 0:
                    while pending:  # the CSV never lags a saved checkpoint
                        drain_one()
                    on_state(r0 + R - 1, engine.checkpoint_state(state))
                while len(pending) > max_in_flight:
                    drain_one()
                if in_prog_ckpt and not pending:
                    flush_checkpoints()
                r0 += R
            while pending:
                drain_one()
            done = True
        except _Fault as fault:
            # everything in flight descends from the poisoned state: drop the
            # metric buffers unread and the stashed checkpoints unwritten
            pending.clear()
            ckpt_stash.clear()
            if rollbacks_left <= 0:
                if recovery.scale_lr is not None and lr_halvings < recovery.max_lr_halvings:
                    lr_halvings += 1
                    lr_scale *= recovery.lr_backoff
                    new_engine = recovery.scale_lr(lr_scale)
                    if new_engine is not None:
                        if in_prog_ckpt:
                            engine.checkpoint_sink = None
                            new_engine.checkpoint_sink = ckpt_stash.append
                        engine = new_engine
                    rollbacks_left = recovery.max_rollbacks
                    if telemetry is not None:
                        telemetry["lr_scale"] = lr_scale
                    print(f"recovery: rollback budget exhausted; inner LR backed off to "
                          f"x{lr_scale:g}")
                else:
                    raise TrainingAborted(
                        f"health flag {fault.code} at round {fault.round}: rollback and "
                        "LR-backoff budgets exhausted") from None
            rollbacks_left -= 1
            restored = recovery.restore()
            if restored is None:
                raise TrainingAborted(f"health flag {fault.code} at round {fault.round} but "
                                      "no valid checkpoint to roll back to") from None
            state, ckpt_round = restored
            skip_to = fault.round + 1
            state = _with_round(state, skip_to)
            if telemetry is not None:
                telemetry["rollbacks"] += 1
                telemetry["skipped_rounds"] += skip_to - ckpt_round
            print(f"recovery: round {fault.round} flagged (code {fault.code}); rolled back "
                  f"to checkpoint round {ckpt_round}, resuming at round {skip_to}")
            r0 = skip_to
    if in_prog_ckpt:
        flush_checkpoints()
        engine.checkpoint_sink = None
    return state, history
