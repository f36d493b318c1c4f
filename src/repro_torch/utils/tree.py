"""Trees of tensors (port of the path helpers of ``repro/utils/tree.py``).

Parameters are nested dicts; optimizer states also nest tuples and carry
``None`` holes (the reference's ``partition`` masks out-of-group leaves to
``None``, an empty pytree node), so :func:`tree_map` walks dicts, tuples and
lists and passes ``None`` through untouched, as ``jax.tree.map`` does.

Paths are ``"a/b/c"`` strings, the same rendering the reference gives
``jax.tree_util`` key paths, so optimizer labels and checkpoint leaves match
across the two packages. ``params_from_numpy`` / ``params_to_numpy`` are the
weight bridge: the reference's params, turned into numpy with
``jax.tree.map(np.asarray, params)``, become port params with the same paths.
``state_from_numpy`` / ``state_to_numpy`` carry whole optimizer and
training states (tuples, ``None`` holes, integer counters) the same way.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

Tree = Any


def tree_map(fn: Callable[..., Any], tree: Tree, *rest: Tree) -> Tree:
    """Map ``fn`` over the leaves of ``tree`` (and the same positions of
    ``rest``); ``None`` is an empty node and stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> list[Any]:
    """Leaves in insertion order (``None`` holes skipped)."""
    out: list[Any] = []
    tree_map(out.append, tree)
    return out


def tree_unzip(tree_of_tuples: Tree, n: int) -> tuple[Tree, ...]:
    """Transpose a dict tree whose leaves are n-tuples into n trees."""
    def split(t, i):
        if isinstance(t, dict):
            return {k: split(v, i) for k, v in t.items()}
        return None if t is None else t[i]

    return tuple(split(tree_of_tuples, i) for i in range(n))


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


def state_from_numpy(tree: Tree, device) -> Tree:
    """A state tree of numpy leaves (dicts, tuples, ``None`` holes, integer
    counters) -> tensors on ``device`` with the same structure and dtypes."""
    return tree_map(lambda x: torch.from_numpy(np.array(x, copy=True)).to(device), tree)


def state_to_numpy(tree: Tree) -> Tree:
    """Inverse of :func:`state_from_numpy`."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)
