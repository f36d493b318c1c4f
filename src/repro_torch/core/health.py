"""In-program health sentinel (port of ``repro/core/health.py``).

When enabled, the round folds a ``{"ema", "n"}`` running-statistics dict
through the TrainState's ``health`` field and emits one float32 flag
bitmask per round:

  * bit 1 — a non-finite value in the round's inner losses;
  * bit 2 — the pseudogradient's sum of squares is non-finite;
  * bit 4 — the round's mean loss above ``spike_factor`` x the running EMA
    (only after ``warmup_rounds`` finite rounds).

The driver drains the flags with the other metrics and hands nonzero ones
to :class:`repro_torch.engine.recovery.RecoveryPolicy`. The update reads
the losses and Psi and never feeds the parameter arithmetic; every op runs
on the device with no host read, so it sits inside a captured round.
Disabled (the default) the state has no ``health`` field and the round
runs no extra op. The EMA lives in the state, so it is checkpointed and a
resumed run replays the same spike decisions.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.utils.tree import tree_leaves

Tree = Any

FLAG_NONFINITE_LOSS = 1
FLAG_NONFINITE_PSI = 2
FLAG_LOSS_SPIKE = 4


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    enabled: bool = False
    spike_factor: float = 3.0  # flag when mean loss > factor * running EMA
    ema_alpha: float = 0.2  # EMA weight of the newest round's mean loss
    warmup_rounds: int = 3  # finite rounds before spike detection arms


def health_init(hcfg: HealthConfig, device="cpu") -> dict | None:
    """The state's ``health`` field (``ema`` f32[], ``n`` i32[]), or None
    when disabled."""
    if not hcfg.enabled:
        return None
    return {"ema": torch.zeros((), dtype=torch.float32, device=device),
            "n": torch.zeros((), dtype=torch.int32, device=device)}


def health_update(hcfg: HealthConfig, health: dict, losses: torch.Tensor,
                  psi: Tree) -> tuple[dict, torch.Tensor]:
    """Fold one round's losses ([H]) and Psi into the running stats; returns
    ``(new_health, flag)`` with ``flag`` the f32 bitmask. The EMA ingests
    finite mean losses only, and ``n`` counts them."""
    losses = losses.float()
    m = torch.mean(losses)
    finite_m = torch.isfinite(m)
    psi_ss = sum(torch.sum(torch.square(x.float())) for x in tree_leaves(psi))
    bad_loss = ~torch.isfinite(torch.sum(losses))
    bad_psi = ~torch.isfinite(psi_ss)
    warm = health["n"] >= hcfg.warmup_rounds
    spike = warm & finite_m & (m > hcfg.spike_factor * health["ema"])
    flag = (FLAG_NONFINITE_LOSS * bad_loss.float() + FLAG_NONFINITE_PSI * bad_psi.float()
            + FLAG_LOSS_SPIKE * spike.float())
    a = torch.full((), hcfg.ema_alpha, dtype=torch.float32, device=m.device)
    ema_next = torch.where(health["n"] == 0, m, (1 - a) * health["ema"] + a * m)
    new = {"ema": torch.where(finite_m, ema_next, health["ema"]),
           "n": health["n"] + finite_m.to(torch.int32)}
    return new, flag
