from repro_torch.utils.tree import (
    params_from_numpy,
    params_to_numpy,
    state_from_numpy,
    state_to_numpy,
    tree_leaves,
    tree_leaves_with_paths,
    tree_map,
    tree_map_with_path,
    tree_paths,
    tree_unzip,
)
