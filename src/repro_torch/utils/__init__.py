from repro_torch.utils.tree import (
    params_from_numpy,
    params_to_numpy,
    tree_leaves_with_paths,
    tree_map_with_path,
    tree_paths,
)
