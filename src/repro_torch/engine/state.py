"""TrainState (port of ``repro/engine/state.py``): a dict of tensor trees
with the reference's field names.

  * ``outer_params`` / ``outer_opt`` — the synced parameters and the outer
    transform's state (``{"u": tree}`` for Nesterov, ``{}`` for SGD);
  * ``worker_params`` / ``inner_state`` — K-stacked replicas and their
    inner-optimizer state (``None`` holes where ``partition`` left them);
  * ``round`` — the int32 round counter, on the device;
  * ``ef`` — the K-stacked error-feedback residuals (compressed syncs);
  * ``participation`` — the [K] fp32 {0, 1} worker mask of an elastic run
    (``DiLoCoConfig(elastic=True)``; all ones at init, then each round's
    row, copied in by the engine before the round runs);
  * ``pending`` — the delayed-sync FIFO (``sync_delay = d``): per leaf a
    [d, ...] fp32 stack of pseudogradients, ``pending[0]`` the oldest, the
    one the next descent applies;
  * ``health`` — the health sentinel's ``{"ema", "n"}`` running stats
    (:mod:`repro_torch.core.health`), checkpointed with the rest.

Every field is updated in place, so a captured round sees the same
tensors from round to round. A field a config does not use is absent, as
in the reference's mapping view of a state; the checkpoint paths of the
two optional fields (``participation``, ``pending/<leaf path>``) are the
reference's, so such a checkpoint loads in either package.
``utils.tree.state_from_numpy`` / ``state_to_numpy`` carry a state across
the two packages field by field.
"""
from __future__ import annotations

from typing import Any

FIELDS = ("outer_params", "outer_opt", "worker_params", "inner_state", "round",
          "ef", "participation", "pending", "health")
REQUIRED = FIELDS[:5]


def train_state(**fields: Any) -> dict:
    """A TrainState dict; rejects unknown fields and drops ``None`` ones."""
    unknown = set(fields) - set(FIELDS)
    missing = set(REQUIRED) - {k for k, v in fields.items() if v is not None}
    if unknown or missing:
        raise KeyError(f"TrainState: unknown fields {sorted(unknown)}, "
                       f"missing {sorted(missing)}")
    return {k: fields[k] for k in FIELDS if fields.get(k) is not None}
