"""The training engine (port of ``repro/engine``): TrainState, TrainEngine
(R rounds per dispatch, a captured round program on the card), the
data-parallel baseline's engine, the round driver and the recovery
policy."""
from repro_torch.engine.driver import run_rounds  # noqa: F401
from repro_torch.engine.engine import TrainEngine, dp_engine  # noqa: F401
from repro_torch.engine.recovery import RecoveryPolicy, TrainingAborted  # noqa: F401
from repro_torch.engine.state import FIELDS, train_state  # noqa: F401
from repro_torch.engine.superstep import (  # noqa: F401
    auto_rounds_per_dispatch,
    build_superstep_fn,
    effective_rounds_per_dispatch,
)
