from repro_torch.configs.base import (
    INPUT_SHAPES,
    InputShape,
    get_config,
    list_configs,
    reduce_config,
    register,
)
