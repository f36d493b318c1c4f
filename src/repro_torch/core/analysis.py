"""Pseudogradient analysis tools (port of ``repro/core/analysis.py``; paper
§4.2-4.3, Figs. 2-5).

Cosine alignment of pseudogradients and optimizer steps, singular-value
spectra before and after averaging, the top-S interference gap (Def. 4.1),
nuclear norms through the orthonormal factor, and the exact Proposition 4.2
identity. Everything is computed in fp32 on the tensors' device; the SVDs
are ``torch.linalg`` calls, as the reference's are ``jnp.linalg`` calls.
Functions return Python floats or tensors where the reference returns
floats or arrays, and keep its keys (``path`` or ``path[i]``).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.utils.tree import tree_leaves_with_paths

Tree = Any


def cosine(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    a = a.reshape(-1).float()
    b = b.reshape(-1).float()
    return torch.dot(a, b) / (torch.linalg.vector_norm(a) * torch.linalg.vector_norm(b) + eps)


def hidden_matrix_leaves(tree: Tree) -> list[tuple[str, torch.Tensor]]:
    """Leaves that Muon treats as hidden matrices (per-layer matrices)."""
    from repro_torch.optim.muon import muon_label

    return [(path, leaf) for path, leaf in tree_leaves_with_paths(tree)
            if muon_label(path, leaf) == "muon"]


def per_matrix_cosines(tree_a: Tree, tree_b: Tree) -> dict[str, float]:
    """Cosine similarity per hidden weight matrix (paper Fig. 2 box plots).

    Stacked [L, m, n] leaves contribute one cosine per layer slice."""
    cos = {}
    b_leaves = dict(hidden_matrix_leaves(tree_b))
    for path, a in hidden_matrix_leaves(tree_a):
        b = b_leaves[path]
        if a.ndim > 2:
            a2 = a.reshape((-1, *a.shape[-2:]))
            b2 = b.reshape((-1, *b.shape[-2:]))
            cs = torch.stack([cosine(x, y) for x, y in zip(a2, b2)]).tolist()
            for i, c in enumerate(cs):
                cos[f"{path}[{i}]"] = c
        else:
            cos[path] = float(cosine(a, b))
    return cos


def singular_values(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.svdvals(x.float())


def orthonormal_factor(x: torch.Tensor) -> torch.Tensor:
    """Psi* = U V^T from the SVD of x."""
    u, _, vt = torch.linalg.svd(x.float(), full_matrices=False)
    return u @ vt


def nuclear_norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(singular_values(x))


def interference_gap(worker_mats: torch.Tensor, s_frac: float = 0.05) -> torch.Tensor:
    """Top-S interference gap G_S (Def. 4.1).

    worker_mats: [K, m, n]. G_S = mean_k topS(σ(Δ_k)) − topS(σ(mean Δ)).
    """
    K, m, n = worker_mats.shape
    r = min(m, n)
    S = max(int(round(s_frac * r)), 1)
    sv_workers = singular_values(worker_mats)  # [K, r]
    sv_mean = singular_values(torch.mean(worker_mats.float(), dim=0))
    return torch.mean(torch.sum(sv_workers[:, :S], dim=1)) - torch.sum(sv_mean[:S])


def prop42_nuclear_identity(steps: torch.Tensor, alphas: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Proposition 4.2: for Ψ = (1/K) Σ_k Σ_h α_h ψ^(h,k),

        ‖Ψ‖_* = (√r / K) Σ_{k,h} ρ^(h,k) α_h ‖ψ^(h,k)‖_F

    steps: [K, H, m, n]; alphas: [H]. Returns (lhs, rhs), equal up to fp error.
    """
    K, H, m, n = steps.shape
    r = min(m, n)
    steps = steps.float()
    alphas = alphas.float()
    psi = torch.einsum("h,khmn->mn", alphas, steps) / K
    lhs = nuclear_norm(psi)
    psi_star = orthonormal_factor(psi)
    norm_star = torch.sqrt(torch.tensor(r, dtype=torch.float32, device=steps.device))
    fro = torch.sqrt(torch.sum(steps ** 2, dim=(-2, -1)))  # [K, H]
    inner = torch.einsum("khmn,mn->kh", steps, psi_star)
    rho = inner / (fro * norm_star + 1e-30)
    rhs = norm_star / K * torch.sum(rho * alphas[None, :] * fro)
    return lhs, rhs


def frobenius_norms(tree: Tree) -> dict[str, float]:
    """Per-hidden-matrix Frobenius norms (paper Fig. 5 step-norm traces)."""
    out = {}
    for path, leaf in hidden_matrix_leaves(tree):
        x = leaf.float()
        if x.ndim > 2:
            x = x.reshape((-1, *x.shape[-2:]))
            norms = torch.sqrt(torch.sum(x * x, dim=(-2, -1))).tolist()
            for i, v in enumerate(norms):
                out[f"{path}[{i}]"] = v
        else:
            out[path] = float(torch.linalg.vector_norm(x))
    return out
