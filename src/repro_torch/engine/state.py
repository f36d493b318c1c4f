"""TrainState (port of ``repro/engine/state.py``): a dict of tensor trees
with the reference's field names.

  * ``outer_params`` / ``outer_opt`` — the synced parameters and the outer
    transform's state (``{"u": tree}`` for Nesterov, ``{}`` for SGD);
  * ``worker_params`` / ``inner_state`` — K-stacked replicas and their
    inner-optimizer state (``None`` holes where ``partition`` left them);
  * ``round`` — the int32 round counter, on the device;
  * ``ef`` — the K-stacked error-feedback residuals (compressed syncs);
  * ``health`` — the health sentinel's ``{"ema", "n"}`` running stats
    (:mod:`repro_torch.core.health`), checkpointed with the rest.

Every field is updated in place, so a captured round sees the same
tensors from round to round. The reference's ``participation`` and
``pending`` belong to Slice 4b (elastic execution); like the reference's
mapping view of a state without them, the dict simply has no such key.
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
