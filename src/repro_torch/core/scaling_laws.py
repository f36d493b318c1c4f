"""Scaling-law fitting machinery (port of ``repro/core/scaling_laws.py``;
paper §7, Tab. 2/6, Figs. 10/13/17/18). The port's own copy: numpy and
scipy, as the reference's, since torch has no L-BFGS-B that computes
the same fit; with the same seed the fits are the reference's.

Power laws L(C) = a*C^alpha (+ L_irr), fit by minimizing a Huber loss on
log-space residuals with L-BFGS-B from many random restarts; a joint
irreducible loss can be shared across methods via the paper's three-phase
grid search. Also: critical-batch-size laws B_crit(D) = a*D^alpha, and the
iso-loss training-time decomposition of Eq. (6).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
from scipy.optimize import minimize


def huber(x: np.ndarray, delta: float = 1e-3) -> np.ndarray:
    a = np.abs(x)
    return np.where(a <= delta, 0.5 * x * x, delta * (a - 0.5 * delta))


@dataclasses.dataclass
class PowerLawFit:
    a: float
    alpha: float
    irr: float
    objective: float

    def predict(self, C: np.ndarray) -> np.ndarray:
        return self.a * np.asarray(C, float) ** self.alpha + self.irr

    def residuals(self, C, L) -> np.ndarray:
        return np.abs(np.log(np.asarray(L, float)) - np.log(self.predict(C)))


def _fit_once(C, L, irr, x0, fit_irr: bool) -> tuple[np.ndarray, float]:
    logC, logL = np.log(C), np.log(L)

    def obj(x):
        la, alpha = x[0], x[1]
        c = np.exp(x[2]) if fit_irr else irr
        pred = np.exp(la + alpha * logC) + c
        return float(np.sum(huber(np.log(pred) - logL)))

    res = minimize(obj, x0, method="L-BFGS-B", options={"maxiter": 15_000})
    return res.x, float(res.fun)


def fit_power_law(C: Sequence[float], L: Sequence[float], irr: float = 0.0,
                  fit_irr: bool = False, restarts: int = 64, seed: int = 0) -> PowerLawFit:
    """Fit L(C) = a C^alpha + irr. ``fit_irr`` learns a per-fit irreducible."""
    C = np.asarray(C, float)
    L = np.asarray(L, float)
    rng = np.random.default_rng(seed)
    best_x, best_f = None, np.inf
    for _ in range(restarts):
        x0 = np.array([
            rng.normal(np.log(L.max()), 2.0),
            -abs(rng.normal(0.2, 0.15)),
            np.log(max(L.min() * rng.uniform(0.2, 0.9), 1e-6)),
        ])
        x0 = x0 if fit_irr else x0[:2]
        try:
            x, f = _fit_once(C, L, irr, x0 if fit_irr else np.concatenate([x0, [0.0]])[:2], fit_irr)
        except Exception:
            continue
        if f < best_f:
            best_x, best_f = x, f
    la, alpha = best_x[0], best_x[1]
    c = float(np.exp(best_x[2])) if fit_irr else irr
    return PowerLawFit(a=float(np.exp(la)), alpha=float(alpha), irr=c, objective=best_f)


def fit_joint_irreducible(datasets: dict[str, tuple[Sequence[float], Sequence[float]]],
                          n_grid: int = 40, restarts: int = 16, seed: int = 0
                          ) -> tuple[float, dict[str, PowerLawFit]]:
    """Paper's three-phase shared-L_irr fit: coarse grid over L_irr, zoom,
    then a final refit of every method at the selected L_irr."""
    all_L = np.concatenate([np.asarray(L, float) for _, L in datasets.values()])
    lo, hi = 1e-3, all_L.min() * 0.999

    def total_obj(irr):
        tot = 0.0
        for C, L in datasets.values():
            f = fit_power_law(C, L, irr=irr, restarts=restarts, seed=seed)
            tot += f.objective
        return tot

    # phase 1: coarse
    grid = np.linspace(lo, hi, n_grid)
    objs = [total_obj(g) for g in grid]
    best = int(np.argmin(objs))
    # phase 2: zoom around the best candidate
    lo2 = grid[max(best - 1, 0)]
    hi2 = grid[min(best + 1, n_grid - 1)]
    grid2 = np.linspace(lo2, hi2, 10)
    objs2 = [total_obj(g) for g in grid2]
    irr = float(grid2[int(np.argmin(objs2))])
    # phase 3: full refit
    fits = {k: fit_power_law(C, L, irr=irr, restarts=restarts * 4, seed=seed)
            for k, (C, L) in datasets.items()}
    return irr, fits


# ---------------------------------------------------------------------------
# Critical batch size (Fig. 12/13) and iso-loss efficiency (Eq. 6)
# ---------------------------------------------------------------------------


def optimal_and_critical_batch(batches: Sequence[float], losses: Sequence[float],
                               tol: float = 0.01) -> tuple[float, float]:
    """B_opt = argmin L; B_crit = largest B with L(B) <= (1+tol) L(B_opt),
    log-linearly interpolated between swept batch sizes."""
    b = np.asarray(batches, float)
    ls = np.asarray(losses, float)
    order = np.argsort(b)
    b, ls = b[order], ls[order]
    i_opt = int(np.argmin(ls))
    b_opt, l_opt = b[i_opt], ls[i_opt]
    thresh = (1.0 + tol) * l_opt
    b_crit = b_opt
    for i in range(i_opt, len(b)):
        if ls[i] <= thresh:
            b_crit = b[i]
        else:  # interpolate crossing in log-B
            l0, l1 = ls[i - 1], ls[i]
            if l1 > l0:
                t = (thresh - l0) / (l1 - l0)
                b_crit = float(np.exp(np.log(b[i - 1]) + t * (np.log(b[i]) - np.log(b[i - 1]))))
            break
    return float(b_opt), float(b_crit)


def iso_loss_time_ratio(loss_fit_ref: PowerLawFit, cbs_fit_ref: PowerLawFit,
                        loss_fit: PowerLawFit, cbs_fit: PowerLawFit,
                        target_loss: float, tokens_per_flop: float = 1.0 / 6.0
                        ) -> dict[str, float]:
    """Eq. (6): T_ref(L)/T_m(L) = compute-savings x parallelism-advantage,
    with T = C / B_crit(C) and D derived from C via chinchilla C = 6 N D,
    D = 20 N  =>  D = sqrt(C * 20 / 6)."""

    def invert_loss(fit: PowerLawFit, L: float) -> float:
        return ((L - fit.irr) / fit.a) ** (1.0 / fit.alpha)

    def seq_time(loss_fit, cbs_fit, L):
        C = invert_loss(loss_fit, L)
        D = np.sqrt(C * 20.0 / 6.0)
        B = cbs_fit.a * D ** cbs_fit.alpha
        return C / B, C, B

    t_ref, c_ref, b_ref = seq_time(loss_fit_ref, cbs_fit_ref, target_loss)
    t_m, c_m, b_m = seq_time(loss_fit, cbs_fit, target_loss)
    return {
        "time_ratio": t_ref / t_m,
        "compute_savings": c_ref / c_m,
        "parallelism_advantage": b_m / b_ref,
    }
