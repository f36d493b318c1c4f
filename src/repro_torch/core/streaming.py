"""Streaming DiLoCo partitioned communication (port of
``repro/core/streaming.py``; Douillard et al., 2025; paper §6.4).

The parameters split into J partitions; partition j syncs after
(j + 1) * H / J of a round's H inner steps, cutting peak bandwidth by J
while the total communication stays the same.

Layers are stored stacked ([L, ...]), so a layer partition is a
broadcastable {0, 1} mask over the L axis (contiguous layer ranges).
Non-stacked leaves (embed, final norm, ...) go whole to the partition
``crc32(path) % J``, the path rendered as the reference renders it, so the
two packages partition alike. Masks are fp32 tensors on the params' device
(the CPU for leaves that are not tensors, which only need a ``shape``):
shape ``(L, 1, ...)`` for stacked leaves, 0-dim otherwise.

On a mesh the masks are made from the outer params' whole shapes (a
DTensor's ``shape`` is the whole tensor's), the same on every rank; the
segment sync slices rows of the rank's whole workers, and
:func:`masked_update` merges the outer state on each rank's block.

A mask tensor keeps its :func:`subset_plan` and :func:`subset_index`
results on itself: the first call reads the mask to the host, every later
one reads nothing, so a captured streaming sync runs no host read. The
engine computes them once (:func:`prepare_plans`) before any capture.
"""
from __future__ import annotations

import zlib
from typing import Any

import numpy as np
import torch

from repro_torch.utils.tree import tree_leaves, tree_map, tree_map_with_path

Tree = Any

LAYER_PREFIXES = ("layers", "self_layers", "cross_layers", "decoder", "encoder")


def streaming_masks(params: Tree, n_partitions: int,
                    layer_prefixes: tuple[str, ...] = LAYER_PREFIXES) -> list[Tree]:
    """J mask trees; elementwise they sum to 1 across partitions."""
    J = n_partitions

    def leaf_mask(path: str, leaf, j: int) -> torch.Tensor:
        device = leaf.device if isinstance(leaf, torch.Tensor) else "cpu"
        is_stacked = any(path.startswith(p) or f"/{p}/" in path for p in layer_prefixes)
        if is_stacked and len(leaf.shape) >= 1 and leaf.shape[0] > 1:
            L = leaf.shape[0]
            part = (torch.arange(L) * J) // L  # contiguous layer ranges
            m = (part == j).to(torch.float32).reshape((L,) + (1,) * (len(leaf.shape) - 1))
            return m.to(device)
        owner = zlib.crc32(path.encode()) % J  # whole-leaf assignment by path
        return torch.tensor(1.0 if owner == j else 0.0, dtype=torch.float32, device=device)

    return [tree_map_with_path(lambda p, x: leaf_mask(p, x, j), params) for j in range(J)]


def subset_plan(mask_leaf, leaf_shape: tuple, ccfg) -> tuple[str, np.ndarray | None]:
    """Classify a mask leaf for wire-row subsetting: ``(plan, idx)``,
    cached on a mask tensor (module docstring).

    * ``'all'``    — the segment owns the whole leaf (encode it whole);
    * ``'skip'``   — the segment owns nothing (encode nothing);
    * ``'rows'``   — a stacked-layer mask whose owned L-rows gather into a
      smaller wire buffer without changing any wire row: only for row-wise
      linear quantization of a >= 2-D leaf;
    * ``'legacy'`` — partial ownership that would split wire rows (global
      quantization rows span the L axis; top-k rounds k per leaf): the
      full-size masked encode, accounted at the masked-row fraction.
    """
    if not isinstance(mask_leaf, torch.Tensor):
        return _subset_plan(np.asarray(mask_leaf), leaf_shape, ccfg)
    cache = mask_leaf.__dict__.setdefault("_subset_plans", {})
    key = (tuple(leaf_shape), ccfg.kind, ccfg.rowwise)
    if key not in cache:
        cache[key] = _subset_plan(mask_leaf.detach().cpu().numpy(), leaf_shape, ccfg)
    return cache[key]


def subset_index(mask_leaf: torch.Tensor, idx: np.ndarray, device) -> torch.Tensor:
    """The owned rows ``idx`` of a ``'rows'`` plan as an index tensor on
    ``device``, made once per mask tensor and device."""
    cache = mask_leaf.__dict__.setdefault("_subset_index", {})
    key = (str(torch.device(device)), idx.tobytes())
    if key not in cache:
        cache[key] = torch.as_tensor(idx, device=device)
    return cache[key]


def prepare_plans(masks: list[Tree], params: Tree, ccfg) -> None:
    """Compute every mask leaf's :func:`subset_plan` (and its index on the
    params' device) for ``params``' leaf shapes, so a later sync reads no
    mask to the host."""
    for mask in masks:
        for p, m in zip(tree_leaves(params), tree_leaves(mask)):
            if isinstance(m, torch.Tensor):
                plan, idx = subset_plan(m, tuple(p.shape), ccfg)
                if plan == "rows":
                    subset_index(m, idx, p.device)


def _subset_plan(m: np.ndarray, leaf_shape: tuple, ccfg) -> tuple[str, np.ndarray | None]:
    if m.ndim == 0:
        return ("all" if m > 0 else "skip"), None
    rows = m.reshape(m.shape[0], -1)  # stacked masks broadcast (L, 1, ..)
    if not (rows.min(axis=1) == rows.max(axis=1)).all():
        raise ValueError("partition mask rows must be constant along non-leading axes "
                         "(streaming_masks makes (L, 1, ...) broadcasts)")
    idx = np.nonzero(rows[:, 0] > 0)[0]
    if idx.size == m.shape[0]:
        return "all", None
    if idx.size == 0:
        return "skip", None
    if ccfg.kind == "quant" and ccfg.rowwise and len(leaf_shape) >= 2:
        return "rows", idx
    return "legacy", None


def masked_update(mask: Tree, new: Tree, old: Tree) -> Tree:
    """new where mask else old (mask broadcast per leaf), in fp32. On a
    mesh ``old`` is a DTensor leaf of the outer state: the merge runs on
    this rank's blocks (the mask's block under ``old``'s layout), the bits
    of the whole merge's block."""
    from repro_torch.core.collectives import block, from_block, local

    def one(m, n, o):
        mb = block(o, m)
        return from_block(o, (mb * local(n).float() + (1.0 - mb) * local(o).float()).to(o.dtype))

    return tree_map(one, mask, new, old)


def assert_masks_partition(masks: list[Tree]) -> bool:
    """Whether the masks tile the parameter set exactly once (test helper)."""
    total = tree_map(lambda *ms: sum(ms), *masks)
    return all(bool(torch.all(torch.isclose(t, torch.ones_like(t))))
               for t in tree_leaves(total))
