"""Analytic FLOP and HBM-traffic models, exact to the model code (port of
``repro/roofline/flops.py``).

The counts read shapes only, so a parameter tree built on the ``meta``
device is a valid input: kimi-k2's full tree costs no memory. For the same
config and arguments every function returns the reference's number bitwise
(the same float operations in the same order). The attention term counts
the reference's visit schedule at the config's ``attn_block_q`` /
``attn_block_kv`` (the useful work by the reference's rules), not the tiles
a given kernel visits, so the count reads the same whatever implements it.
The reference checks these formulas against unrolled HLO; the port's
check is ``torch.utils.flop_counter.FlopCounterMode`` on its plain forward
(``tests/test_torch_config.py``).

Conventions: a matmul [m,k]x[k,n] costs 2mkn; backward = 2x forward matmul
cost; remat adds one extra forward through scanned blocks.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.common import ModelConfig


def _attn_flops(cfg: ModelConfig, S: int, T: int, kv_len: int | None = None) -> float:
    """Forward attention flops for T query tokens (seq len S context).

    kv_len overrides context length (decode: cache length; sliding window).
    Full-seq training/prefill at blockwise lengths uses the reference's
    *visit schedule* (block-granular causal/sliding-window skipping at
    ``attn_block_q`` x ``attn_block_kv``; attn_impl 'pallas', the flash
    kernels, at every length, the blockwise plain path 'xla' above the
    threshold) as the effective-context term, instead of the smooth ctx/2
    approximation. The CUDA kernels visit tiles of their own, so this is
    the useful work, not their exact visits. ``forward_flops`` passes the
    B sequences' tokens as T, so ``full_seq`` holds only at B = 1: at B > 1
    the score term counts the whole context, as the reference's does.
    """
    hd = cfg.hd
    H, KV = cfg.n_heads, cfg.n_kv_heads
    d = cfg.d_model
    ctx = kv_len if kv_len is not None else S
    if cfg.sliding_window:
        ctx = min(ctx, cfg.sliding_window)
    proj = 2.0 * T * d * (H * hd) + 2.0 * 2.0 * T * d * (KV * hd) + 2.0 * T * (H * hd) * d
    full_seq = T == S and kv_len is None
    # the flash kernels ('pallas') count the block schedule at every length;
    # the plain path ('xla') only above the blockwise threshold
    blocked = cfg.attn_impl == "pallas" or S >= cfg.blockwise_threshold
    if full_seq and blocked:
        from repro_torch.kernels.flash_attention import visited_fraction

        # block-granular skipping: the reference's impls visit this fraction
        eff_ctx = S * visited_fraction(S, cfg.attn_block_q, cfg.attn_block_kv,
                                       causal=True, window=cfg.sliding_window)
    elif full_seq and not cfg.sliding_window:
        eff_ctx = ctx / 2.0  # causal averaging for the dense path
    else:
        eff_ctx = ctx
    scores = 2.0 * T * H * hd * eff_ctx * 2.0
    return proj + scores


def _mlp_flops(cfg: ModelConfig, T: int, d_ff: int | None = None) -> float:
    ff = cfg.d_ff if d_ff is None else d_ff
    mats = 3.0 if cfg.activation == "swiglu" else 2.0
    return mats * 2.0 * T * cfg.d_model * ff


def _moe_flops(cfg: ModelConfig, T: int) -> float:
    router = 2.0 * T * cfg.d_model * cfg.n_experts
    routed = cfg.experts_per_token * 3.0 * 2.0 * T * cfg.d_model * cfg.d_ff
    shared = 0.0
    if cfg.n_shared_experts:
        shared = 3.0 * 2.0 * T * cfg.d_model * (cfg.d_ff * cfg.n_shared_experts)
    return router + routed + shared


def _ssm_flops(cfg: ModelConfig, T: int, decode: bool = False) -> float:
    d, di, N, H, P, Q = (cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads,
                         cfg.ssm_head_dim, cfg.ssm_chunk)
    proj = 2.0 * T * d * (2 * di + 2 * N + H) + 2.0 * T * di * d
    if decode:
        core = T * H * P * N * 6.0  # state update + readout
    else:
        # chunked SSD: intra-chunk (CB^T QxQ, M*x) + states + off-diag
        intra = 2.0 * T * Q * N + 2.0 * T * Q * H * P
        states = 2.0 * T * N * H * P * 2.0
        core = intra + states
    return proj + core


def _block_flops(cfg: ModelConfig, S: int, T: int, kv_len: int | None = None) -> float:
    """One generic layer for each family (forward)."""
    if cfg.arch_type in ("dense",):
        return _attn_flops(cfg, S, T, kv_len) + _mlp_flops(cfg, T)
    if cfg.arch_type == "moe":
        return _attn_flops(cfg, S, T, kv_len) + _moe_flops(cfg, T)
    if cfg.arch_type == "ssm":
        return _ssm_flops(cfg, T, decode=(T < S))
    raise ValueError(cfg.arch_type)


def forward_flops(cfg: ModelConfig, S: int, B: int, T: int | None = None,
                  kv_len: int | None = None) -> float:
    """Forward flops for B sequences; T = query tokens per sequence
    (T=S for train/prefill, T=1 for decode)."""
    T = S if T is None else T
    tokens = float(B * T)
    head = 2.0 * tokens * cfg.d_model * cfg.vocab if T == S or T == 1 else 0.0
    if T == 1:
        head = 2.0 * B * cfg.d_model * cfg.vocab

    if cfg.arch_type in ("dense", "moe"):
        per_layer = _block_flops(cfg, S, tokens, kv_len)
        return cfg.n_layers * per_layer + head
    if cfg.arch_type == "ssm":
        return cfg.n_layers * _ssm_flops(cfg, tokens, decode=(T == 1)) + head
    if cfg.arch_type == "hybrid":
        n_super = cfg.n_layers // cfg.hybrid_period
        mamba = cfg.n_layers * _ssm_flops(cfg, tokens, decode=(T == 1))
        attn_ctx = kv_len if T == 1 else None
        shared = n_super * (_attn_flops(cfg, S, tokens, attn_ctx) + _mlp_flops(cfg, tokens))
        return mamba + shared + head
    if cfg.arch_type == "audio":
        Le = cfg.n_encoder_layers or cfg.n_layers
        F = cfg.n_audio_frames
        ftoks = float(B * F)
        enc = Le * (_attn_flops(cfg.replace(sliding_window=0), F, ftoks) + _mlp_flops(cfg, ftoks))
        if T == 1:
            enc = 0.0  # encoder runs once per request, not per decode step
        dec_self = cfg.n_layers * _attn_flops(cfg, S, tokens, kv_len)
        cross_kv = 0.0 if T == 1 else cfg.n_layers * 2.0 * 2.0 * ftoks * cfg.d_model * (cfg.n_kv_heads * cfg.hd)
        dec_cross = cfg.n_layers * (2.0 * tokens * cfg.d_model * (cfg.n_heads * cfg.hd)
                                    + 2.0 * tokens * cfg.n_heads * cfg.hd * F * 2.0
                                    + 2.0 * tokens * (cfg.n_heads * cfg.hd) * cfg.d_model)
        dec_mlp = cfg.n_layers * _mlp_flops(cfg, tokens)
        return enc + dec_self + cross_kv + dec_cross + dec_mlp + head
    if cfg.arch_type == "vlm":
        ns = cfg.n_layers // cfg.vlm_period
        n_self = cfg.n_layers - ns
        img = cfg.n_image_tokens
        itoks = float(B * img)
        self_l = n_self * (_attn_flops(cfg, S, tokens, kv_len) + _mlp_flops(cfg, tokens))
        cross_kv = 0.0 if T == 1 else ns * 2.0 * 2.0 * itoks * cfg.d_model * (cfg.n_kv_heads * cfg.hd)
        cross = ns * (2.0 * tokens * cfg.d_model * (cfg.n_heads * cfg.hd)
                      + 2.0 * tokens * cfg.n_heads * cfg.hd * img * 2.0
                      + 2.0 * tokens * (cfg.n_heads * cfg.hd) * cfg.d_model
                      + _mlp_flops(cfg, tokens))
        proj = 2.0 * itoks * cfg.d_model * cfg.d_model if T != 1 else 0.0
        return self_l + cross_kv + cross + proj + head
    raise ValueError(cfg.arch_type)


def newton_schulz_flops(m: int, n: int, iters: int = 5) -> float:
    """Per NS orthogonalization of an [m, n] matrix (m <= n after transpose)."""
    a = min(m, n)
    b = max(m, n)
    per_iter = 2.0 * a * a * b + 2.0 * a * a * a + 2.0 * a * a * b  # XX^T, A@A, B@X
    return iters * per_iter


def optimizer_flops(params_tree, inner_name: str) -> float:
    """Per-step optimizer flops across the whole parameter tree."""
    from repro_torch.optim.muon import muon_label
    from repro_torch.utils.tree import tree_leaves_with_paths

    total = 0.0
    for path, leaf in tree_leaves_with_paths(params_tree):
        size = 1
        for d in leaf.shape:
            size *= int(d)
        # muon_bp/normuon share Muon's NS cost model (muon_bp amortizes it by
        # ns_period on accelerators; we account the orthogonalizing step)
        muon_family = inner_name in ("muon", "muon_bp", "normuon")
        if muon_family and muon_label(path, leaf) == "muon":
            *batch, m, n = leaf.shape
            nb = 1
            for d in batch:
                nb *= int(d)
            total += nb * newton_schulz_flops(int(m), int(n)) + 6.0 * size
        else:
            total += 12.0 * size  # adamw elementwise
    return total


@dataclasses.dataclass
class StepFlops:
    forward: float
    backward: float
    optimizer: float
    remat_extra: float

    @property
    def total(self) -> float:
        return self.forward + self.backward + self.optimizer + self.remat_extra


def train_step_flops(cfg: ModelConfig, S: int, B: int, params_tree, inner_name: str) -> StepFlops:
    fwd = forward_flops(cfg, S, B)
    bwd = 2.0 * fwd
    remat = fwd if cfg.remat else 0.0
    opt = optimizer_flops(params_tree, inner_name)
    return StepFlops(fwd, bwd, opt, remat)


# ---------------------------------------------------------------------------
# HBM traffic (per chip, per step)
# ---------------------------------------------------------------------------


def hbm_bytes(kind: str, *, param_bytes_chip: float, opt_state_bytes_chip: float,
              act_bytes_chip: float, cache_bytes_chip: float = 0.0) -> float:
    """Coarse per-chip HBM traffic model.

    train:   read params (fwd + bwd + remat fwd ~ 3x), read+write opt state,
             write grads + activations ~ 2x act
    prefill: read params once + activation traffic
    decode:  read params + read full cache + small writes  (bandwidth-bound)
    """
    if kind == "train":
        return 3.0 * param_bytes_chip + 2.0 * opt_state_bytes_chip + 2.0 * act_bytes_chip
    if kind == "prefill":
        return param_bytes_chip + 2.0 * act_bytes_chip
    if kind == "decode":
        return param_bytes_chip + cache_bytes_chip + act_bytes_chip
    if kind == "sync":
        # outer step touches outer params + u + worker deltas (+EF)
        return 4.0 * param_bytes_chip + opt_state_bytes_chip
    raise ValueError(kind)
