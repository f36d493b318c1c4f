"""The ``Transform`` protocol (port of ``repro/optim/transform.py``).

A ``Transform`` is an optax-style pair of functions plus a hook for terminal
(parameter-applying) stages::

    state            = t.init(tree)
    updates, state   = t.update(updates, state, params)
    params, state    = t.apply(params, updates, state)        # terminal only
    state            = t.mask_state(mask, new_state, old)     # streaming sync

``chain`` composes transforms left to right; ``partition`` routes disjoint
parameter groups through different transforms, replacing out-of-group
leaves with ``None`` holes so each group's state only holds buffers for the
leaves it owns (Muon's AdamW second moment exists only for the AdamW
leaves). Terminal stages see the params and do the descent themselves, so
the reference's association ``(p - lr*u) - lr*wd*p`` is kept exactly.

A streaming (J > 1) segment sync merges a terminal stage's new state into
the old one under the partition mask with ``mask_state``.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.utils.tree import tree_leaves, tree_map, tree_map_with_path

Tree = Any


class Transform(NamedTuple):
    init: Callable[[Tree], Tree]
    update: Callable[[Tree, Tree, Tree], tuple[Tree, Tree]]
    # terminal stages only: (params, updates, state) -> (new_params, new_state)
    apply: Callable[[Tree, Tree, Tree], tuple[Tree, Tree]] | None = None
    # streaming (masked) sync: (mask, new_state, old_state) -> merged_state
    mask_state: Callable[[Tree, Tree, Tree], Tree] | None = None


def stateless(fn: Callable[[Tree, Tree], Tree]) -> Transform:
    """Lift ``fn(updates, params) -> updates`` into a stateless Transform."""
    return Transform(init=lambda tree: (), update=lambda u, s, p: (fn(u, p), s))


def chain(*transforms: Transform) -> Transform:
    """Compose transforms left to right; state is the tuple of stage states.
    Only the last stage may be terminal; ``chain`` delegates ``apply`` and
    ``mask_state`` to it."""
    for t in transforms[:-1]:
        if t.apply is not None:
            raise ValueError("only the final transform in a chain may be "
                             "terminal (define apply)")

    def init(tree: Tree) -> Tree:
        return tuple(t.init(tree) for t in transforms)

    def update(updates: Tree, state: Tree, params: Tree):
        new_states = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            new_states.append(s)
        return updates, tuple(new_states)

    apply = None
    mask_state = None
    if transforms and transforms[-1].apply is not None:
        last = transforms[-1]

        def apply(params: Tree, updates: Tree, state: Tree):
            new_params, last_state = last.apply(params, updates, state[-1])
            return new_params, (*state[:-1], last_state)

        if last.mask_state is not None:
            def mask_state(mask, new_state, old_state):
                merged = last.mask_state(mask, new_state[-1], old_state[-1])
                return (*new_state[:-1], merged)

    return Transform(init=init, update=update, apply=apply, mask_state=mask_state)


# ---------------------------------------------------------------------------
# partition: route disjoint parameter groups through different transforms
# ---------------------------------------------------------------------------


def _group(labels: Tree, tree: Tree, name: str) -> Tree:
    """Copy of ``tree`` with out-of-group leaves replaced by ``None`` holes."""
    return tree_map(lambda lb, x: x if lb == name else None, labels, tree)


def _merge(labels: Tree, group_trees: dict[str, Tree]) -> Tree:
    """Inverse of ``_group``: each leaf comes from the group that owns it."""
    if isinstance(labels, dict):
        return {k: _merge(v, {n: t[k] for n, t in group_trees.items()})
                for k, v in labels.items()}
    return group_trees[labels]


def partition(label_fn: Callable[[str, Any], str],
              transforms: dict[str, Transform]) -> Transform:
    """Apply a different transform per parameter group: ``label_fn(path,
    leaf) -> group name`` assigns every leaf to exactly one group, and each
    group's transform sees the tree with the other groups' leaves masked to
    ``None``."""

    def labels_of(tree: Tree) -> Tree:
        labels = tree_map_with_path(label_fn, tree)
        unknown = set(tree_leaves(labels)) - set(transforms)
        if unknown:
            raise ValueError(f"label_fn produced groups {sorted(unknown)} "
                             f"with no transform (have {sorted(transforms)})")
        return labels

    def init(tree: Tree) -> Tree:
        labels = labels_of(tree)
        return {name: t.init(_group(labels, tree, name)) for name, t in transforms.items()}

    def update(updates: Tree, state: Tree, params: Tree):
        labels = labels_of(params)
        outs, new_states = {}, {}
        for name, t in transforms.items():
            outs[name], new_states[name] = t.update(
                _group(labels, updates, name), state[name], _group(labels, params, name))
        return _merge(labels, outs), new_states

    return Transform(init=init, update=update)


# ---------------------------------------------------------------------------
# Generic building-block transforms
# ---------------------------------------------------------------------------


def _zero_count(tree: Tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    device = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=device)


def scale_by_schedule(sched: Callable) -> Transform:
    """Multiply updates by ``sched(count)`` with an own step counter."""

    def init(tree: Tree) -> Tree:
        return {"count": _zero_count(tree)}

    def update(updates: Tree, state: Tree, params: Tree):
        count = state["count"] + 1
        s = sched(count)
        return tree_map(lambda x: s * x, updates), {"count": count}

    return Transform(init=init, update=update)


def apply_updates(params: Tree, updates: Tree) -> Tree:
    """Default application for non-terminal chains: p <- p + u (fp32 math)."""
    return tree_map(lambda p, u: (p.float() + u.float()).to(p.dtype), params, updates)
