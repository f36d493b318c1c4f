"""DiLoCo/MuLoCo distributed optimization (port of ``repro/core``): the
single-card round, with compressed and streaming pseudogradient syncs,
elastic participation, the delayed outer sync and the data-parallel
baseline."""
from repro_torch.core.compression import CompressionConfig  # noqa: F401
from repro_torch.core.diloco import (  # noqa: F401
    DiLoCoConfig,
    OuterOptimizer,
    comm_bytes,
    compute_deltas,
    diloco_init,
    diloco_round,
    dp_config,
    dp_init,
    dp_step,
    inner_step,
    make_optimizer,
    make_outer,
    make_streaming_masks,
    outer_step,
    round_constants,
)
from repro_torch.core.health import HealthConfig, health_init, health_update  # noqa: F401
