from repro_torch.configs.base import (
    ASSIGNED_ARCHS,
    INPUT_SHAPES,
    InputShape,
    config_for_shape,
    get_config,
    list_configs,
    reduce_config,
    register,
    shape_supported,
)
