"""Fault injection (port of ``repro/core/faults.py``): worker churn for
elastic DiLoCo, and crash and corruption chaos.

Elastic execution models a lost worker (a preemption, a hardware fault, a
straggler cut off at the round barrier) as a per-round **participation
mask**: a [K] float32 {0, 1} vector carried in the TrainState's
``participation`` field. A dropped worker freezes in place for the round
(no inner steps, no wire packet, its EF residual untouched), and the
pseudogradient mean runs over the survivors; at the sync every worker,
the dropped one included, resets to the new outer params, so rejoining is
the normal broadcast. :class:`FaultPlan` is the host side: a scripted drop
schedule (:func:`parse_drop_schedule`) and an i.i.d. drop probability turn
into the ``[R, K]`` masks of a dispatch. A mask is a pure function of
``(seed, absolute round)`` (numpy's ``SeedSequence``), bitwise the
reference's, so any rounds-per-dispatch chunking and any resume sees the
same masks.

:class:`CrashPlan` injects driver-level faults so the crash-safety path
(checksummed checkpoints, the health sentinel, the recovery policy,
preemption) can be shown end to end: poison a chosen round's state with a
NaN, overwrite one parameter with a large finite value (a loss spike),
SIGKILL the process at a chosen round, and, for tests, truncate or
bit-flip a checkpoint file.

Poisoning writes into the state's tensors in place. A captured round reads
and writes fixed addresses, so this is what reaches it: the next replay
sees the poisoned value.
"""
from __future__ import annotations

import dataclasses
import os
import signal

import numpy as np
import torch

from repro_torch.utils.tree import tree_leaves_with_paths


def parse_drop_schedule(spec: str) -> dict[int, tuple[int, ...]]:
    """Parse ``'round:worker[;round:worker...]'`` into {round: (workers,)}.

    ``'1:2;1:3;4:0'`` drops workers 2 and 3 in round 1 and worker 0 in round
    4 (0-indexed; a worker drops only in the rounds listed). ``;`` and ``,``
    both separate entries."""
    sched: dict[int, list[int]] = {}
    for entry in spec.replace(",", ";").split(";"):
        entry = entry.strip()
        if not entry:
            continue
        try:
            r_s, w_s = entry.split(":")
            r, w = int(r_s), int(w_s)
        except ValueError as e:
            raise ValueError(
                f"bad --drop-schedule entry {entry!r}: expected 'round:worker'") from e
        if r < 0 or w < 0:
            raise ValueError(f"--drop-schedule entry {entry!r}: negative index")
        sched.setdefault(r, []).append(w)
    return {r: tuple(sorted(set(ws))) for r, ws in sched.items()}


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Host-side participation-mask generator for an elastic run.

    ``drop_prob`` drops each worker independently per round; ``schedule``
    (:func:`parse_drop_schedule`) forces (round, worker) drops on top. At
    least one worker always survives: when a round would drop everyone, the
    worker with the largest draw (the last one any drop rate would evict)
    stays, the tie-break of ``wallclock.StragglerModel``.

    On a mesh every rank builds the same plan from the same flags and gets
    the same [K] masks: a mask depends on ``(seed, round)`` alone (numpy's
    ``SeedSequence``, no process state), so no rank needs another's. Each
    rank then reads its own workers' entries of the replicated mask
    (``collectives.local_workers``)."""

    n_workers: int
    drop_prob: float = 0.0
    schedule: dict[int, tuple[int, ...]] | None = None
    seed: int = 0

    def mask_for_round(self, r: int) -> np.ndarray:
        """[K] float32 {0, 1} participation of absolute round ``r``."""
        K = self.n_workers
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, r]))
        u = rng.random(K)
        active = np.ones(K, bool) if self.drop_prob <= 0 else (u >= self.drop_prob)
        for w in (self.schedule or {}).get(r, ()):
            if w < K:
                active[w] = False
        if not active.any():
            active[int(np.argmax(u))] = True
        return active.astype(np.float32)

    def masks(self, r0: int, n: int) -> np.ndarray:
        """[n, K] float32 masks of rounds ``r0 .. r0+n-1``."""
        return np.stack([self.mask_for_round(r0 + i) for i in range(n)])

    @property
    def is_trivial(self) -> bool:
        return self.drop_prob <= 0 and not self.schedule


@dataclasses.dataclass(frozen=True)
class CrashPlan:
    """Scripted crash and corruption events.

    * ``nan_round``: set one worker-parameter entry to NaN at the dispatch
      that starts at this round (``apply`` is the driver's ``inject`` hook;
      the caller pins ``rounds_per_dispatch=1`` while it is armed);
    * ``spike_round``: set that entry to ``spike_value`` instead, a finite
      corruption the EMA spike detector catches;
    * ``kill_round``: SIGKILL this process once the round's metrics have
      drained (:meth:`maybe_kill`, called from ``on_round`` after the row is
      written; on a mesh every rank, after a barrier behind rank 0's row).

    On a mesh ``apply`` takes ``held``, the global workers this rank holds:
    the poison lands on global worker 0 on the ranks that hold it, and only
    there, as in the one-process run.
    """

    nan_round: int | None = None
    spike_round: int | None = None
    kill_round: int | None = None
    spike_value: float = 100.0

    @property
    def is_trivial(self) -> bool:
        return self.nan_round is None and self.spike_round is None and self.kill_round is None

    @property
    def needs_single_round_dispatch(self) -> bool:
        """State poisoning edits the state at a dispatch boundary; R must be
        1 so the boundary is the target round."""
        return self.nan_round is not None or self.spike_round is not None

    @staticmethod
    def _poison(state: dict, value: float, held: list[int] | None = None) -> dict:
        """Set worker 0's first entry of the first parameter leaf (the
        reference's ``jax.tree.leaves`` order: sorted paths), in place; with
        ``held`` (the global workers of this rank's [K / pod] stack) only a
        rank that holds worker 0 writes, at its local index."""
        if held is not None and 0 not in held:
            return state
        k = 0 if held is None else held.index(0)
        leaf = tree_leaves_with_paths(state["worker_params"])[0][1]
        with torch.no_grad():
            leaf[(k,) + (0,) * (leaf.dim() - 1)] = value
        return state

    def apply(self, r0: int, n: int, batches, state, held: list[int] | None = None):
        """The driver's ``inject`` hook for rounds r0..r0+n-1. Returns
        ``(batches, state)``."""
        if self.nan_round is not None and r0 == self.nan_round:
            state = self._poison(state, float("nan"), held)
        if self.spike_round is not None and r0 == self.spike_round:
            state = self._poison(state, self.spike_value, held)
        return batches, state

    def maybe_kill(self, round: int) -> None:
        """SIGKILL this process when ``round``'s metrics have drained."""
        if self.kill_round is not None and round == self.kill_round:
            os.kill(os.getpid(), signal.SIGKILL)


def truncate_file(path: str, keep_bytes: int = 0) -> None:
    """Truncate a file in place: a torn write."""
    with open(path, "r+b") as f:
        f.truncate(keep_bytes)


def corrupt_file(path: str, offset: int = -64, flip: int = 0xFF) -> None:
    """Flip the bits of one byte in place: corruption only a checksum
    catches."""
    size = os.path.getsize(path)
    pos = offset % size
    with open(path, "r+b") as f:
        f.seek(pos)
        b = f.read(1)
        f.seek(pos)
        f.write(bytes([b[0] ^ flip]))
