"""Superstep executor: R communication rounds per dispatch (port of
``repro/engine/superstep.py``).

The reference scans its jitted round over R rounds inside one device
program. Here the unit of dispatch is the *round program*
(:func:`round_program`): the round function with the eval loss of the
freshly synced outer params folded in. On the CPU it runs eagerly; on the
card the engine captures it once in a CUDA graph and replays it
(:mod:`repro_torch.engine.engine`). :func:`build_superstep_fn` runs R of
them back to back with no host read in between:

  * batches arrive round-stacked ``[R, H, K, B, ...]`` and each round takes
    its slice;
  * each round's metrics are copied into this dispatch's output buffers
    (``loss`` f32[R, H], ``comm_bytes`` f32[R], ``eval_loss`` f32[R] when
    eval batches are passed, ``health`` f32[R] when the sentinel is on),
    which the driver drains once per dispatch;
  * the round counter lives in the state and advances on the device;
  * an elastic run passes its ``[R, K]`` participation masks (host arrays,
    ``core/faults.FaultPlan``): they are staged on the device once per
    dispatch, each round's row is copied into the state's ``participation``
    before it runs (a captured engine copies a state that is not its own
    into its tensors, the mask with the rest), and the host's copy of the
    row names the round's program (dense when every worker takes part,
    masked otherwise), so nothing is read back;
  * R = 1 is the degenerate case and also returns the round's ``psi``.

Every R that divides the run runs the same arithmetic, bit for bit.
``ckpt_flags`` (a length-R sequence of bools) hands the post-round state
of each flagged round to ``checkpoint_cb``, which only copies it out, so
flagged and unflagged rounds compute the same numbers.
"""
from __future__ import annotations

import math
from typing import Any, Callable

import numpy as np
import torch

Tree = Any

# Fraction of a dispatch the host may cost before the cost model grows R
# ("auto"): R* is the smallest span divisor with
# host_overhead <= MAX_DISPATCH_OVERHEAD_FRAC * R * device_round_time.
MAX_DISPATCH_OVERHEAD_FRAC = 0.01

# per-round metrics stacked into the dispatch's buffers (psi is not)
STACKED = ("loss", "comm_bytes", "active_workers", "staleness", "eval_loss", "health")


def round_program(round_fn: Callable, eval_loss_fn: Callable | None = None) -> Callable:
    """``program(state, round_batches, eval_batch=None, masked=None) ->
    (state, info)``: one round, then (when ``eval_loss_fn`` and an eval
    batch are given) ``info["eval_loss"]``, the loss of the post-sync outer
    params. ``masked`` names an elastic round's program
    (``round_fn(state, batches, masked=)``)."""

    def program(state, batches, eval_batch=None, masked=None):
        state, info = (round_fn(state, batches) if masked is None
                       else round_fn(state, batches, masked=masked))
        if eval_loss_fn is not None and eval_batch is not None:
            info = {**info, "eval_loss": eval_loss_fn(state["outer_params"], eval_batch)}
        return state, info

    return program


def _slice(tree: dict, i: int) -> dict:
    return {k: v[i] for k, v in tree.items()}


def stage_masks(participation, R: int, device) -> tuple[list[bool], torch.Tensor]:
    """``[R, K]`` host masks (numpy or lists) -> (per round: does it drop a
    worker?, the masks on ``device``). On the card the copy goes through
    pinned memory without a host wait."""
    host = np.asarray(participation, np.float32).reshape(R, -1)
    masked = [not bool((row > 0).all()) for row in host]
    rows = torch.from_numpy(host.copy())
    if torch.device(device).type == "cuda":
        rows = rows.pin_memory().to(device, non_blocking=True)
    return masked, rows


def build_superstep_fn(round_fn: Callable, eval_loss_fn: Callable | None = None,
                       checkpoint_cb: Callable | None = None, *,
                       program: Callable | None = None) -> Callable:
    """Wrap a round function into the R-rounds-per-dispatch executor.

    ``round_fn(state, round_batches[, masked=]) -> (state, {"loss": f32[H],
    "psi": ..., ...})`` is :func:`repro_torch.core.diloco.diloco_round`
    bound to its model and config. ``program`` (default
    :func:`round_program` of ``round_fn`` and ``eval_loss_fn``) is what runs
    each round: the engine passes its captured replay there. The returned
    ``superstep_fn(state, batches, eval_batches=None, participation=None,
    ckpt_flags=None)`` takes batches with leaves ``[R, H, K, B, ...]`` (and
    eval batches ``[R, B, ...]``, host masks ``[R, K]``) and returns
    ``(state, out)``, ``out`` holding the stacked metrics (module
    docstring) and, at R = 1, ``psi``."""
    program = program or round_program(round_fn, eval_loss_fn)

    def superstep_fn(state: dict, batches: dict, eval_batches: dict | None = None,
                     participation=None, ckpt_flags=None) -> tuple[dict, dict]:
        R = batches["tokens"].shape[0]
        if participation is not None and state.get("participation") is None:
            raise ValueError("per-round participation masks need an elastic TrainState "
                             "(DiLoCoConfig(elastic=True)): the state has no participation "
                             "field")
        if ckpt_flags is not None and checkpoint_cb is None:
            raise ValueError("ckpt_flags passed but the superstep was built without a "
                             "checkpoint_cb host sink (build_superstep_fn(checkpoint_cb=))")
        if ckpt_flags is not None and len(ckpt_flags) != R:
            raise ValueError(f"ckpt_flags holds {len(ckpt_flags)} flags for {R} rounds")
        do_eval = eval_loss_fn is not None and eval_batches is not None
        if participation is not None:
            masked, rows = stage_masks(participation, R, state["round"].device)
        out: dict = {}
        for i in range(R):
            kw = {}
            if participation is not None:
                with torch.no_grad():
                    state["participation"].copy_(rows[i])
                kw["masked"] = masked[i]
            state, info = program(state, _slice(batches, i),
                                  _slice(eval_batches, i) if do_eval else None, **kw)
            for k in STACKED:
                if k in info:
                    v = info[k]
                    if k not in out:
                        out[k] = torch.empty((R, *v.shape), dtype=torch.float32,
                                             device=v.device)
                    out[k][i].copy_(v)
            if R == 1 and "psi" in info:
                out["psi"] = info["psi"]
            if ckpt_flags is not None and ckpt_flags[i]:
                checkpoint_cb(state)
        return state, out

    return superstep_fn


def auto_rounds_per_dispatch(rounds_to_run: int,
                             host_overhead_s: float | None = None,
                             device_round_s: float | None = None,
                             max_overhead_frac: float = MAX_DISPATCH_OVERHEAD_FRAC) -> int:
    """Cost-model choice of R: the smallest divisor of ``rounds_to_run``
    with ``host_overhead_s <= max_overhead_frac * R * device_round_s``;
    unmeasured, the whole span (one dispatch for the run)."""
    if rounds_to_run <= 1:
        return max(1, rounds_to_run)
    if not host_overhead_s or not device_round_s:
        return rounds_to_run
    need = host_overhead_s / (max_overhead_frac * device_round_s)
    for r in range(1, rounds_to_run + 1):
        if rounds_to_run % r == 0 and r >= need:
            return r
    return rounds_to_run


def effective_rounds_per_dispatch(requested, rounds_to_run: int,
                                  checkpoint_every: int = 0,
                                  start: int = 0, *,
                                  host_overhead_s: float | None = None,
                                  device_round_s: float | None = None) -> int:
    """Clamp a requested R to the run's cadences: the gcd of R with the
    rounds left, and (checkpointing on) with the interval and a resumed
    ``start``, so every cadence boundary is a dispatch boundary.
    ``"auto"`` asks :func:`auto_rounds_per_dispatch` first. Callers that
    checkpoint inside the dispatch pass ``checkpoint_every=0``."""
    if requested == "auto":
        r = auto_rounds_per_dispatch(rounds_to_run, host_overhead_s, device_round_s)
    else:
        r = max(1, int(requested))
    if rounds_to_run > 0:
        r = math.gcd(r, rounds_to_run)
    if checkpoint_every:
        r = math.gcd(r, checkpoint_every)
        if start:
            r = math.gcd(r, start)
    return max(1, r)
