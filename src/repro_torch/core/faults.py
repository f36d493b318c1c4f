"""Crash and corruption injection (port of the crash half of
``repro/core/faults.py``).

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

import torch

from repro_torch.utils.tree import tree_leaves_with_paths


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
      written).
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
    def _poison(state: dict, value: float) -> dict:
        """Set worker 0's first entry of the first parameter leaf (the
        reference's ``jax.tree.leaves`` order: sorted paths), in place."""
        leaf = tree_leaves_with_paths(state["worker_params"])[0][1]
        with torch.no_grad():
            leaf[(0,) * leaf.dim()] = value
        return state

    def apply(self, r0: int, n: int, batches, state):
        """The driver's ``inject`` hook for rounds r0..r0+n-1. Returns
        ``(batches, state)``."""
        if self.nan_round is not None and r0 == self.nan_round:
            state = self._poison(state, float("nan"))
        if self.spike_round is not None and r0 == self.spike_round:
            state = self._poison(state, self.spike_value)
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
