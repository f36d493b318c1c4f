"""Nested-dict parameter trees (port of the path helpers of ``repro/utils/tree.py``).

Paths are ``"a/b/c"`` strings, the same rendering the reference gives
``jax.tree_util`` key paths, so optimizer labels and checkpoint leaves match
across the two packages. ``params_from_numpy`` / ``params_to_numpy`` are the
weight bridge: the reference's params, turned into numpy with
``jax.tree.map(np.asarray, params)``, become port params with the same paths.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

Tree = Any


def tree_map_with_path(fn: Callable[[str, Any], Any], tree: Tree, prefix: str = "") -> Tree:
    """Map ``fn(path_string, leaf)`` over a tree of nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    return fn(prefix, tree)


def tree_leaves_with_paths(tree: Tree) -> list[tuple[str, Any]]:
    out: list[tuple[str, Any]] = []
    tree_map_with_path(lambda p, x: out.append((p, x)), tree)
    return sorted(out, key=lambda px: px[0])


def tree_paths(tree: Tree) -> list[str]:
    return [p for p, _ in tree_leaves_with_paths(tree)]


def params_from_numpy(tree: Tree, device, dtype: torch.dtype | None = None) -> Tree:
    """numpy leaves -> tensors on ``device`` with the same paths (floating
    leaves cast to ``dtype`` when given)."""
    def leaf(_, x):
        t = torch.from_numpy(np.array(x, copy=True)).to(device)
        return t.to(dtype) if dtype is not None and t.is_floating_point() else t

    return tree_map_with_path(leaf, tree)


def params_to_numpy(tree: Tree) -> Tree:
    """Inverse of :func:`params_from_numpy`: tensors -> numpy arrays."""
    return tree_map_with_path(lambda _, t: t.detach().cpu().numpy(), tree)
