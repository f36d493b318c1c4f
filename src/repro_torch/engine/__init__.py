"""The training engine (port of ``repro/engine``): TrainState, TrainEngine
and the round driver."""
from repro_torch.engine.driver import run_rounds  # noqa: F401
from repro_torch.engine.engine import TrainEngine  # noqa: F401
from repro_torch.engine.state import FIELDS, train_state  # noqa: F401
