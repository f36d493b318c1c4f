"""DiLoCo/MuLoCo distributed optimization (port of ``repro/core``): the
single-card lockstep round with compression ``none``."""
from repro_torch.core.diloco import (  # noqa: F401
    CompressionConfig,
    DiLoCoConfig,
    OuterOptimizer,
    comm_bytes,
    compute_deltas,
    diloco_init,
    diloco_round,
    inner_step,
    make_optimizer,
    make_outer,
    outer_step,
)
