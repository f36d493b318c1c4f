"""Driver-side recovery (port of ``repro/engine/recovery.py``): what
:func:`repro_torch.engine.driver.run_rounds` does when a drained health
flag is nonzero.

1. **rollback**: restore the last valid checkpoint (``restore``, typically
   :func:`repro_torch.checkpoint.load_latest_valid` over the run's
   directory);
2. **skip**: set the restored state's round counter past the flagged round.
   Batches are a pure function of (seed, round), so that never feeds the
   offending span again;
3. **escalate**: rollbacks are budgeted (``max_rollbacks``); when the budget
   runs dry and ``scale_lr`` is given, the inner LR backs off by
   ``lr_backoff`` and the budget refills, at most ``max_lr_halvings`` times;
   then the run stops with :class:`TrainingAborted`.

All of it runs on the host; the round never branches on health.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

Tree = Any


class TrainingAborted(RuntimeError):
    """Recovery escalation exhausted (or no valid checkpoint to roll back
    to): the run cannot make trustworthy progress and stops."""


@dataclasses.dataclass
class RecoveryPolicy:
    """``restore()`` returns ``(state, checkpoint_round)`` or ``None`` when
    nothing valid exists (the run aborts). ``scale_lr(scale)`` (optional)
    rebuilds the engine with the inner LR multiplied by ``scale`` and
    returns it, or ``None`` to keep the current engine."""

    restore: Callable[[], tuple[Tree, int] | None]
    max_rollbacks: int = 3
    scale_lr: Callable[[float], Any] | None = None
    lr_backoff: float = 0.5
    max_lr_halvings: int = 1
