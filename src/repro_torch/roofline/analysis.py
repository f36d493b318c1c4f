"""Roofline terms on one NVIDIA H100 (port of ``repro/roofline/analysis.py``).

Three terms per program, in seconds:

    compute    = analytic FLOPs / peak FLOP/s
    memory     = analytic HBM bytes / HBM bandwidth
    collective = on-mesh collective bytes / link bandwidth (0 on one card)

The FLOP and byte counts are the closed-form models of :mod:`.flops`; the
reference parses its collective bytes out of XLA's optimized HLO
(``parse_collective_bytes``), which a PyTorch program does not have, so that
function has no twin here. The wire term (``wire_bytes``) takes the
pseudogradient bytes a sync moves, from the sizes of the wire buffers
(``repro_torch.core.collectives.measured_sync_bytes``).

The peaks are one H100 SXM's, from NVIDIA's data sheet (700 W): dense bf16
on the tensor cores, fp32 on the CUDA cores (outside the tensor cores),
HBM3, and NVLink 4 per direction (900 GB/s both ways). A card set below
700 W runs slower under load, so print its power limit beside a share.
"""
from __future__ import annotations

import dataclasses

PEAK_FLOPS = 989e12  # bf16, dense, tensor cores
PEAK_FP32_FLOPS = 67e12  # fp32 on the CUDA cores
HBM_BW = 3.35e12
LINK_BW = 450e9


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_FLOPS) -> dict:
    """The least time a kernel could take for ``flops`` operations at
    ``peak_flops`` and ``nbytes`` moved at :data:`HBM_BW`: ``bound_ms`` the
    larger of the two, ``bound_by`` which one it is."""
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / HBM_BW * 1e3
    return dict(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes")


@dataclasses.dataclass
class RooflineTerms:
    flops: float
    hlo_bytes: float
    collective_bytes: float
    chips: int
    model_flops: float = 0.0
    amortize: float = 1.0  # divide by H for the sync step
    # measured cross-worker pseudogradient wire bytes for the whole program
    # (per worker, from the actual wire buffers: collectives.
    # measured_sync_bytes). 0 for programs without an outer sync.
    wire_bytes: float = 0.0

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS / self.amortize

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes / HBM_BW / self.amortize

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / LINK_BW / self.amortize

    @property
    def wire_comm_s(self) -> float:
        """Cross-worker wire time at NVLink speed (a lower bound; the
        cross-DC links DiLoCo targets are slower: scale by LINK_BW/bw)."""
        return self.wire_bytes / LINK_BW / self.amortize

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / analytic FLOPs (per-chip flops x chips)."""
        total_hlo = self.flops * self.chips
        return self.model_flops / total_hlo if total_hlo else 0.0

    def as_dict(self) -> dict:
        return {
            "flops_per_chip": self.flops,
            "hlo_bytes_per_chip": self.hlo_bytes,
            "collective_bytes_per_chip": self.collective_bytes,
            "wire_bytes_per_worker": self.wire_bytes,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "wire_comm_s": self.wire_comm_s,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
        }


def model_flops(kind: str, n_active_params: float, tokens: float) -> float:
    """6*N*D for train, 2*N*D for inference forward (per step, all chips).

    ``round`` (the engine's fused H-step+sync executor) passes the round's
    total token count, so it is 6*N*D like train."""
    if kind in ("train", "round"):
        return 6.0 * n_active_params * tokens
    if kind in ("prefill", "decode"):
        return 2.0 * n_active_params * tokens
    return 0.0


def active_params(cfg, total_params: float) -> float:
    """MoE active params: replace routed-expert mass with top-k fraction."""
    if not cfg.n_experts:
        return total_params
    # routed expert params per layer: 3 * d_model * d_ff per expert
    routed = cfg.n_layers * cfg.n_experts * 3 * cfg.d_model * cfg.d_ff
    active_routed = routed * (cfg.experts_per_token / cfg.n_experts)
    return total_params - routed + active_routed
