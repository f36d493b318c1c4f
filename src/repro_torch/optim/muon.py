"""Muon — the paper's MuLoCo inner optimizer, as a transform chain (port of
``repro/optim/muon.py``).

Momentum accumulation followed by 5 quintic Newton–Schulz iterations that
orthogonalize each hidden weight-matrix update (a, b, c = 3.4445, -4.7750,
2.0315), with decoupled weight decay. Embeddings, norms, biases and the
output head fall back to AdamW::

    partition(muon_label, {
        "muon":  chain(trace_momentum(cfg), orthogonalize(cfg, ns_impl)),
        "adamw": scale_by_adam(cfg),
    })

wrapped by :func:`repro_torch.optim.base.descend` with the per-shape lr
scale. Stacked ``[L, m, n]`` leaves are orthogonalized per matrix.

``ns_impl='pallas'`` runs the Newton–Schulz matmuls through the Hopper
matmul-epilogue kernel (``kernels/ops.ns_orthogonalize``, fp32 iterations,
one launch per call for the whole stack); ``'jnp'`` is the reference's
plain mode, normalised in fp32 and iterated in bf16, in plain PyTorch. The
reference's ``shard_hint`` resharding hints are no-ops on one card and are
left out. Variants (MuonBP, NorMuon) swap or extend the "muon" chain:
:mod:`repro_torch.optim.muon_variants`.

Under tensor parallelism (``core/collectives.py``) a rank holds its
block of each split matrix: the momentum is gathered whole over 'model'
before Newton–Schulz and the rank keeps its block of the result, and the
lr scale reads the whole matrix's shape.
"""
from __future__ import annotations

import math
import re
from typing import Any

import torch

from repro_torch.optim.adamw import scale_by_adam
from repro_torch.optim.base import Optimizer, OptimizerConfig, descend
from repro_torch.optim.transform import Transform, chain, partition, stateless
from repro_torch.utils.tree import tree_map, tree_map_with_path

Tree = Any

NS_COEFFS = (3.4445, -4.7750, 2.0315)

# Parameters that never receive Muon (paper: embeddings, norms, output layer;
# extended with SSM scalar/vector state and conv filters).
_ADAMW_PATTERN = re.compile(
    r"(embed|unembed|head|norm|bias|scale|dt_bias|a_log|d_skip|conv|rope|router_bias)",
    re.IGNORECASE,
)


def muon_label(path: str, leaf) -> str:
    """'muon' for hidden matmul matrices, 'adamw' otherwise."""
    if _ADAMW_PATTERN.search(path):
        return "adamw"
    shape = leaf.shape
    if len(shape) < 2 or shape[-1] < 2 or shape[-2] < 2:
        return "adamw"
    return "muon"


def param_labels(params: Tree) -> Tree:
    return tree_map_with_path(muon_label, params)


def _ns_body(X: torch.Tensor) -> torch.Tensor:
    """One quintic NS iteration on [..., m, n]."""
    a, b, c = NS_COEFFS
    A = X @ X.transpose(-1, -2)
    B = b * A + c * (A @ A)
    return a * X + B @ X


def newton_schulz(G: torch.Tensor, iters: int = 5, eps: float = 1e-7) -> torch.Tensor:
    """Orthogonalize the trailing two dims of G via quintic Newton–Schulz, in
    bf16 with an fp32 normalisation (the reference's ``ns_impl='jnp'``)."""
    orig_dtype = G.dtype
    *batch, m, n = G.shape
    X = G.reshape((-1, m, n)).float()
    transpose = m > n
    if transpose:
        X = X.transpose(-1, -2)
    norm = torch.sqrt(torch.sum(X * X, dim=(-2, -1), keepdim=True)) + eps
    X = (X / norm).to(torch.bfloat16)
    for _ in range(iters):
        X = _ns_body(X)
    if transpose:
        X = X.transpose(-1, -2)
    return X.reshape((*batch, m, n)).to(orig_dtype)


def newton_schulz_pallas(G: torch.Tensor, iters: int = 5, eps: float = 1e-7) -> torch.Tensor:
    """Same contract as :func:`newton_schulz`, through the Hopper kernel (fp32)."""
    from repro_torch.kernels.ops import ns_orthogonalize

    return ns_orthogonalize(G, iters=iters, eps=eps)


def ns_fn_for(ns_impl: str):
    return newton_schulz_pallas if ns_impl == "pallas" else newton_schulz


def _muon_lr_scale(shape: tuple[int, ...], mode: str) -> float:
    m, n = int(shape[-2]), int(shape[-1])
    if mode == "paper":  # paper §5: rescale lr by sqrt(n/m) for W in R^{m x n}
        return math.sqrt(n / m)
    if mode == "jordan":
        return max(1.0, m / n) ** 0.5
    if mode == "moonlight":
        return 0.2 * math.sqrt(max(m, n))
    if mode == "none":
        return 1.0
    raise ValueError(f"unknown muon lr scale mode {mode!r}")


# ---------------------------------------------------------------------------
# The Muon transform stages
# ---------------------------------------------------------------------------


def trace_momentum(cfg: OptimizerConfig) -> Transform:
    """Muon momentum: m_t = beta * m_{t-1} + g_t (no (1-beta) dampening).
    Passes the fp32 accumulator downstream, stores it in ``state_dtype``."""
    b1 = cfg.b1
    sdt = getattr(torch, cfg.state_dtype)

    def init(tree: Tree) -> Tree:
        return {"m": tree_map(lambda p: torch.zeros(p.shape, dtype=sdt, device=p.device), tree)}

    def update(updates: Tree, state: Tree, params: Tree):
        m = tree_map(lambda g, m: b1 * m.float() + g.float(), updates, state["m"])
        return m, {"m": tree_map(lambda x: x.to(sdt), m)}

    return Transform(init=init, update=update)


def ns_tree(ns_fn, iters: int, u: Tree) -> Tree:
    """``ns_fn`` on each [..., m, n] update of a tree; a leaf split over
    'model' is orthogonalized whole (``collectives.on_whole``)."""
    from repro_torch.core.collectives import on_whole

    return tree_map_with_path(
        lambda path, m: on_whole(path, m, lambda w: ns_fn(w, iters=iters).float()), u)


def orthogonalize(cfg: OptimizerConfig, ns_impl: str = "jnp") -> Transform:
    """Newton–Schulz orthogonalization of each [..., m, n] update."""
    ns_fn = ns_fn_for(ns_impl)
    iters = cfg.ns_iters
    return stateless(lambda u, _params: ns_tree(ns_fn, iters, u))


def muon_partition(cfg: OptimizerConfig, muon_chain: Transform) -> Transform:
    """``partition(muon_label, {muon: <chain>, adamw: scale_by_adam})``."""
    return partition(muon_label, {"muon": muon_chain, "adamw": scale_by_adam(cfg)})


def muon_mults(cfg: OptimizerConfig, adamw_lr_ratio: float = 1.0):
    """Per-leaf (update, decay) lr multipliers: hidden matrices get the
    shape-dependent Muon scale (decay at the base lr); AdamW-fallback leaves
    get the optional lr ratio on both terms."""

    def mults(path: str, leaf) -> tuple[float, float]:
        from repro_torch.core.collectives import whole_shape

        if muon_label(path, leaf) == "muon":
            return _muon_lr_scale(whole_shape(path, tuple(leaf.shape)),
                                  cfg.muon_lr_scale_mode), 1.0
        return adamw_lr_ratio, adamw_lr_ratio

    return mults


def muon(cfg: OptimizerConfig, ns_impl: str = "jnp", adamw_lr_ratio: float = 1.0) -> Optimizer:
    """Muon for hidden matrices + AdamW for everything else."""
    tx = muon_partition(cfg, chain(trace_momentum(cfg), orthogonalize(cfg, ns_impl)))
    return descend(tx, cfg, muon_mults(cfg, adamw_lr_ratio))
