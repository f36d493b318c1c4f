"""Pure-SSM LM (mamba2-370m) and hybrid SSM + shared-attention LM
(zamba2-2.7b) (port of ``repro/models/ssm_lm.py``).

zamba2: a stack of Mamba2 layers with ONE weight-shared transformer block
(GQA attention + MLP) invoked every ``hybrid_period`` layers
(arXiv:2411.15242). The mamba layers are stacked ``[n_super, period, ...]``;
the shared block's params are unstacked and closed over by every
superblock, so its weights appear once in the tree and their gradients sum
over the invocations, while each invocation keeps its own KV cache during
decode (the ring cache of ``attention.init_cache``, one layer a
superblock).

Where the reference scans, the port loops in Python; with ``cfg.remat``
each layer (ssm) or superblock (hybrid) runs under
``torch.utils.checkpoint``, as the reference ``jax.checkpoint``s the scan
body. Decode caches are written in place (the reference returns new ones).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models import attention as attn
from repro_torch.models.common import ModelConfig, dense_init, embed_init, remat, rms_norm
from repro_torch.models.lm import _embed, _group, _layer, _logits, _unstack
from repro_torch.models.mlp import init_mlp, mlp
from repro_torch.models.ssm import init_mamba, init_ssm_state, mamba_decode, mamba_forward

Tree = Any


def _final(cfg: ModelConfig, params: Tree, x: torch.Tensor, last_only: bool,
           hidden_only: bool) -> tuple[torch.Tensor, torch.Tensor]:
    if last_only:
        x = x[:, -1:]
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if hidden_only:
        return rms_norm(x, params["final_norm_scale"]), zero
    return _logits(cfg, params, x), zero


# ---------------------------------------------------------------------------
# Pure Mamba2 LM
# ---------------------------------------------------------------------------


def init_ssm_lm(gen: torch.Generator, cfg: ModelConfig, device) -> Tree:
    L = cfg.n_layers
    pd = cfg.pdtype
    return {
        "embed": embed_init(gen, (cfg.vocab, cfg.d_model), dtype=pd, device=device),
        "layers": {
            "mamba": init_mamba(gen, cfg, device, n_layers=L),
            "ln_scale": torch.zeros((L, cfg.d_model), dtype=pd, device=device),
        },
        "final_norm_scale": torch.zeros((cfg.d_model,), dtype=pd, device=device),
        "head": dense_init(gen, (cfg.d_model, cfg.vocab), fan_in=cfg.d_model, dtype=pd,
                           device=device),
    }


def _mamba_layer(cfg: ModelConfig, x: torch.Tensor, lp: Tree) -> torch.Tensor:
    return x + mamba_forward(lp["mamba"], cfg, rms_norm(x, lp["ln_scale"]))


def forward_ssm_lm(cfg: ModelConfig, params: Tree, tokens: torch.Tensor,
                   last_only: bool = False, hidden_only: bool = False,
                   **_) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (logits [B, S, V] (or the final-normed hidden
    states with ``hidden_only``), aux 0)."""
    x = _embed(cfg, params, tokens)
    for lp in _unstack(params["layers"], cfg.n_layers):
        if cfg.remat:
            x = remat(lambda x, lp=lp: _mamba_layer(cfg, x, lp), x)
        else:
            x = _mamba_layer(cfg, x, lp)
    return _final(cfg, params, x, last_only, hidden_only)


def init_cache_ssm_lm(cfg: ModelConfig, params: Tree, batch: int, cache_len: int) -> Tree:
    del cache_len  # O(1) state
    return init_ssm_state(cfg, batch, cfg.n_layers, params["embed"].device)


def decode_step_ssm_lm(cfg: ModelConfig, params: Tree, cache: Tree, token: torch.Tensor,
                       pos: int, **_) -> tuple[torch.Tensor, Tree]:
    """One decode step. token [B] int; cache from ``init_cache_ssm_lm``
    (written in place). Returns (logits [B, V], cache)."""
    del pos
    x = _embed(cfg, params, token[:, None])
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        h, _ = mamba_decode(lp["mamba"], cfg, rms_norm(x, lp["ln_scale"]), _layer(cache, i))
        x = x + h
    return _logits(cfg, params, x)[:, 0], cache


# ---------------------------------------------------------------------------
# Zamba2 hybrid
# ---------------------------------------------------------------------------


def _n_super(cfg: ModelConfig) -> int:
    assert cfg.n_layers % cfg.hybrid_period == 0, "n_layers must divide into superblocks"
    return cfg.n_layers // cfg.hybrid_period


def init_hybrid_lm(gen: torch.Generator, cfg: ModelConfig, device) -> Tree:
    pd = cfg.pdtype
    params = init_ssm_lm(gen, cfg, device)
    ns, per = _n_super(cfg), cfg.hybrid_period
    params["layers"] = _group(params["layers"], ns, per)
    params["shared_block"] = {
        "attn": attn.init_attention(gen, cfg, device),
        "mlp": init_mlp(gen, cfg, device),
        "ln1_scale": torch.zeros((cfg.d_model,), dtype=pd, device=device),
        "ln2_scale": torch.zeros((cfg.d_model,), dtype=pd, device=device),
    }
    return params


def _shared_block_fwd(cfg: ModelConfig, sp: Tree, x: torch.Tensor,
                      positions: torch.Tensor) -> torch.Tensor:
    x = x + attn.attend(sp["attn"], cfg, rms_norm(x, sp["ln1_scale"]), positions)
    return x + mlp(sp["mlp"], cfg, rms_norm(x, sp["ln2_scale"]))


def forward_hybrid_lm(cfg: ModelConfig, params: Tree, tokens: torch.Tensor,
                      last_only: bool = False, hidden_only: bool = False,
                      **_) -> tuple[torch.Tensor, torch.Tensor]:
    """As :func:`forward_ssm_lm`; each superblock is the shared block, then
    ``hybrid_period`` mamba layers."""
    x = _embed(cfg, params, tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    sp = params["shared_block"]
    per = cfg.hybrid_period

    def superblock(x, group):
        x = _shared_block_fwd(cfg, sp, x, positions)
        for lp in _unstack(group, per):
            x = _mamba_layer(cfg, x, lp)
        return x

    for group in _unstack(params["layers"], _n_super(cfg)):
        x = remat(superblock, x, group) if cfg.remat else superblock(x, group)
    return _final(cfg, params, x, last_only, hidden_only)


def init_cache_hybrid_lm(cfg: ModelConfig, params: Tree, batch: int, cache_len: int) -> Tree:
    """{"ssm": [ns, period, ...] states, "attn": a ring cache of
    min(cache_len, window) slots a superblock}."""
    ns = _n_super(cfg)
    device = params["embed"].device
    if cfg.sliding_window:
        cache_len = min(cache_len, cfg.sliding_window)
    ssm = _group(init_ssm_state(cfg, batch, cfg.n_layers, device), ns, cfg.hybrid_period)
    return {"ssm": ssm, "attn": attn.init_cache(cfg, batch, cache_len, ns, device)}


def decode_step_hybrid_lm(cfg: ModelConfig, params: Tree, cache: Tree, token: torch.Tensor,
                          pos: int, **_) -> tuple[torch.Tensor, Tree]:
    """One decode step against ``init_cache_hybrid_lm``'s cache (written in
    place); ``pos`` the token's position (a Python int)."""
    x = _embed(cfg, params, token[:, None])
    sp = params["shared_block"]
    for i in range(_n_super(cfg)):
        h, _ = attn.attend_decode(sp["attn"], cfg, rms_norm(x, sp["ln1_scale"]),
                                  _layer(cache["attn"], i), pos)
        x = x + h
        x = x + mlp(sp["mlp"], cfg, rms_norm(x, sp["ln2_scale"]))
        group, states = _layer(params["layers"], i), _layer(cache["ssm"], i)
        for j in range(cfg.hybrid_period):
            lp = _layer(group, j)
            h, _ = mamba_decode(lp["mamba"], cfg, rms_norm(x, lp["ln_scale"]),
                                _layer(states, j))
            x = x + h
    return _logits(cfg, params, x)[:, 0], cache
