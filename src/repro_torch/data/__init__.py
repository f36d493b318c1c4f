from repro_torch.data.synthetic import (  # noqa: F401
    DataConfig,
    MarkovStream,
    batches_for_round,
    batches_for_span,
)
