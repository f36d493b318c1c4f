"""Composable optimizer stack (port of ``repro/optim``): one ``Transform``
protocol from the inner step to the outer sync.

* :mod:`repro_torch.optim.transform` — ``Transform``, ``chain``,
  ``partition`` (``None`` holes), ``stateless``, ``scale_by_schedule``;
* :func:`repro_torch.optim.base.descend` — a direction chain -> an
  ``Optimizer`` (schedule, per-leaf lr scale, decoupled weight decay);
* inner optimizers (``--inner``): ``adamw`` (DiLoCo), ``muon``
  (MuLoCo), and the chain-built variants of
  :mod:`repro_torch.optim.muon_variants`: ``muon_bp`` (block-periodic
  Newton–Schulz every ``OptimizerConfig.ns_period`` steps) and ``normuon``
  (a neuron-wise RMS post-scale);
* outer transforms (``--outer``): ``nesterov`` (paper Eq. 3, optionally
  through the fused Hopper kernel) and ``sgd``.
"""
import torch

from repro_torch.optim.adamw import adamw, scale_by_adam  # noqa: F401
from repro_torch.optim.base import (  # noqa: F401
    Optimizer,
    OptimizerConfig,
    constant_schedule,
    cosine_schedule,
    descend,
    make_schedule,
)
from repro_torch.optim.muon import (  # noqa: F401
    muon,
    muon_label,
    newton_schulz,
    orthogonalize,
    param_labels,
    trace_momentum,
)
from repro_torch.optim.muon_variants import (  # noqa: F401
    muon_bp,
    normuon,
    orthogonalize_periodic,
    scale_by_neuron_rms,
)
from repro_torch.optim.nesterov import nesterov, outer_sgd  # noqa: F401
from repro_torch.optim.transform import (  # noqa: F401
    Transform,
    apply_updates,
    chain,
    partition,
    scale_by_schedule,
    stateless,
)


# Single-source registries: the CLI choice lists and the builder dispatch
# derive from the same dicts.
_INNER_BUILDERS = {"adamw": adamw, "muon": muon, "muon_bp": muon_bp,
                   "normuon": normuon}
_OUTER_BUILDERS = {
    "nesterov": lambda lr, momentum, state_dtype, kernel: nesterov(
        lr, momentum, state_dtype=state_dtype, kernel=kernel),
    "sgd": lambda lr, momentum, state_dtype, kernel: outer_sgd(lr),
}
INNER_OPTIMIZERS = tuple(_INNER_BUILDERS)
OUTER_OPTIMIZERS = tuple(_OUTER_BUILDERS)


def make_inner_optimizer(name: str, cfg: OptimizerConfig, **kw) -> Optimizer:
    """'adamw' -> DiLoCo, 'muon' -> MuLoCo, plus the chain-built variants
    'muon_bp' (block-periodic NS) and 'normuon'."""
    if name not in _INNER_BUILDERS:
        raise ValueError(f"unknown inner optimizer {name!r} "
                         f"(have {sorted(_INNER_BUILDERS)})")
    if name == "adamw":
        kw.pop("ns_impl", None)
    return _INNER_BUILDERS[name](cfg, **kw)


def make_outer_transform(name: str, lr: float, momentum: float, *,
                         state_dtype="float32", kernel: bool = False) -> Transform:
    """Registry for the outer (pseudogradient) descent: 'nesterov' | 'sgd'."""
    if name not in _OUTER_BUILDERS:
        raise ValueError(f"unknown outer optimizer {name!r} "
                         f"(have {sorted(_OUTER_BUILDERS)})")
    return _OUTER_BUILDERS[name](lr, momentum, getattr(torch, str(state_dtype)), kernel)
