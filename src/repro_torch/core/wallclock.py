"""Idealized wall-clock and bandwidth model (port of
``repro/core/wallclock.py``; paper Fig. 9/16/20, Tab. 10).

Training time = compute + optimizer overhead + communication, where data
parallelism communicates 2·P·4 bytes every step (ring all-reduce) and
DiLoCo / MuLoCo communicate the (optionally compressed) pseudogradient
every H steps. The compute term comes from a roofline model of the
hardware (:class:`HardwareModel`), not from measured step times.

:class:`StragglerModel` adds per-worker latency variation: every round each
worker draws a lognormal latency multiplier and, independently, a drop
coin; the sync waits for the slowest *surviving* worker, and the sampled
per-round times answer what a p99 worker costs a lockstep sync, the tail
that elastic DiLoCo (worker drops, a delayed sync) trades against.

Numpy only, as in the reference (the peaks are the roofline's constants).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.roofline.analysis import HBM_BW, LINK_BW, PEAK_FLOPS


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    # defaults: one NVIDIA H100 SXM, the roofline's peaks
    # (repro_torch.roofline.analysis); the reference's defaults describe
    # another chip, so pass one explicit HardwareModel to compare the two
    # packages
    peak_flops: float = PEAK_FLOPS
    hbm_bw: float = HBM_BW
    link_bw: float = LINK_BW
    chips: int = 256
    assumed_mfu: float = 0.4


@dataclasses.dataclass(frozen=True)
class RunSpec:
    n_params: float
    n_active_params: float  # = n_params for dense
    batch_tokens: float
    seq_len: int
    n_steps: int
    sync_interval: int = 1  # H (1 => DP: communicate every step)
    n_workers: int = 1
    # wire bytes vs fp32; prefer the measured ratio
    # (collectives.measured_compression_ratio) where a parameter tree exists
    compression_ratio: float = 1.0
    # measured wire bytes per sync per worker; > 0 overrides the ratio model
    # (set it from collectives.measured_sync_bytes)
    wire_bytes_per_sync: float = 0.0
    optimizer_overhead: float = 0.0096  # paper Tab. 9: +0.96% for Muon


def step_compute_time(spec: RunSpec, hw: HardwareModel) -> float:
    flops = 6.0 * spec.n_active_params * spec.batch_tokens
    return flops / (hw.chips * hw.peak_flops * hw.assumed_mfu)


def sync_comm_time(spec: RunSpec, bandwidth_bps: float) -> float:
    """Pseudogradient bytes per sync over the link: the measured per-sync
    wire bytes when the spec carries them, else the ring all-reduce volume
    2·P·4 bytes scaled by the compression ratio. ``bandwidth_bps`` is in
    bits/s (the paper quotes Gbit/s links)."""
    bytes_wire = (spec.wire_bytes_per_sync
                  or 2.0 * spec.n_params * 4.0 * spec.compression_ratio)
    return bytes_wire * 8.0 / bandwidth_bps


def training_time_hours(spec: RunSpec, bandwidth_bps: float,
                        hw: HardwareModel = HardwareModel()) -> float:
    t_step = step_compute_time(spec, hw) * (1.0 + spec.optimizer_overhead)
    t_sync = sync_comm_time(spec, bandwidth_bps)
    n_syncs = spec.n_steps / spec.sync_interval
    total = spec.n_steps * t_step + n_syncs * t_sync
    return total / 3600.0


def compute_utilization(spec: RunSpec, bandwidth_bps: float,
                        hw: HardwareModel = HardwareModel()) -> float:
    """Fraction of time spent computing (paper Fig. 16), with no overlap."""
    t_step = step_compute_time(spec, hw)
    t_sync_per_step = sync_comm_time(spec, bandwidth_bps) / spec.sync_interval
    return t_step / (t_step + t_sync_per_step)


# ---------------------------------------------------------------------------
# Stragglers and churn: the per-round wall clock as a distribution
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StragglerModel:
    """Per-worker latency and drop model over the deterministic estimate.

    Every round worker k draws a lognormal multiplier ``L_k = exp(sigma*z -
    sigma^2/2)`` (mean 1) and an independent drop coin. The lockstep sync
    waits for the slowest surviving worker: ``t_round = H * t_step * (1 +
    overhead) * max_k L_k + t_sync`` over the active set. The coins share
    one uniform per (round, worker), dropped iff ``u < drop_prob``, so a
    higher drop rate only removes workers from the max and the round-time
    percentiles never rise with it. At least one worker survives: the
    largest draw, as in ``faults.FaultPlan``. With ``sigma == 0`` and
    ``drop_prob == 0`` the samples collapse, bit for bit, to the
    deterministic round time."""

    sigma: float = 0.0  # lognormal sigma of the per-worker latency multiplier
    drop_prob: float = 0.0  # per-(round, worker) drop probability
    seed: int = 0
    n_rounds: int = 2048  # Monte-Carlo rounds sampled

    @property
    def is_trivial(self) -> bool:
        return self.sigma == 0.0 and self.drop_prob == 0.0

    def sample(self, n_workers: int) -> tuple[np.ndarray, np.ndarray]:
        """(latency multipliers [n_rounds, K], active mask [n_rounds, K])."""
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, n_workers]))
        u = rng.random((self.n_rounds, n_workers))
        z = rng.standard_normal((self.n_rounds, n_workers))
        lat = np.exp(self.sigma * z - 0.5 * self.sigma * self.sigma)
        active = u >= self.drop_prob
        all_drop = ~active.any(axis=1)
        if all_drop.any():
            rows = np.nonzero(all_drop)[0]
            active[rows, np.argmax(u[rows], axis=1)] = True
        return lat, active


def straggler_round_times(spec: RunSpec, bandwidth_bps: float, model: StragglerModel,
                          hw: HardwareModel = HardwareModel()) -> np.ndarray:
    """Sampled per-round wall-clock seconds ([model.n_rounds])."""
    t_step = step_compute_time(spec, hw) * (1.0 + spec.optimizer_overhead)
    t_sync = sync_comm_time(spec, bandwidth_bps)
    lat, active = model.sample(spec.n_workers)
    slowest = np.where(active, lat, 0.0).max(axis=1)
    return spec.sync_interval * t_step * slowest + t_sync


def straggler_stats(spec: RunSpec, bandwidth_bps: float, model: StragglerModel,
                    hw: HardwareModel = HardwareModel()) -> dict:
    """p50 / p99 / mean round seconds under the straggler model, the
    deterministic lockstep round and ``p99_over_det``, the tail a lockstep
    sync pays at this sigma and drop rate."""
    times = straggler_round_times(spec, bandwidth_bps, model, hw)
    t_step = step_compute_time(spec, hw) * (1.0 + spec.optimizer_overhead)
    det = spec.sync_interval * t_step + sync_comm_time(spec, bandwidth_bps)
    return {
        "p50_round_s": float(np.percentile(times, 50)),
        "p99_round_s": float(np.percentile(times, 99)),
        "mean_round_s": float(times.mean()),
        "deterministic_round_s": float(det),
        "p99_over_det": float(np.percentile(times, 99) / det),
    }
