"""Whisper-large-v3 transformer backbone (port of ``repro/models/whisper.py``,
arXiv:2212.04356).

Encoder-decoder: a bidirectional audio encoder over precomputed frame
embeddings (the mel-spectrogram and conv frontend are a stub: the context
is [B, n_audio_frames, d_model] and ``frontend_proj`` stands in for the
convolutions) and a causal text decoder with cross-attention. As the
reference, the backbone is MHA, GELU FFN and pre-norm, the encoder adds
fixed sinusoidal embeddings, and both self-attentions apply RoPE; the
encoder's runs non-causal (the flash kernel's ``causal=False`` walk with
``attn_impl='pallas'``).

Where the reference scans over the stacked layers, the port loops in
Python; with ``cfg.remat`` each layer body runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``). Decode
caches are written in place: ``fill_context_whisper`` runs the encoder
once a request and writes every decoder layer's cross K/V into the cache.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models import attention as attn
from repro_torch.models.common import (
    ModelConfig,
    dense_init,
    embed_init,
    remat,
    rms_norm,
    sinusoidal_positions,
)
from repro_torch.models.lm import _embed, _layer, _unstack
from repro_torch.models.mlp import init_mlp, mlp

Tree = Any


def _n_encoder(cfg: ModelConfig) -> int:
    return cfg.n_encoder_layers or cfg.n_layers


def init_whisper(gen: torch.Generator, cfg: ModelConfig, device) -> Tree:
    pd = cfg.pdtype
    Le, Ld, d = _n_encoder(cfg), cfg.n_layers, cfg.d_model

    def zeros(*shape):
        return torch.zeros(shape, dtype=pd, device=device)

    enc_layers = {
        "attn": attn.init_attention(gen, cfg, device, n_layers=Le),
        "mlp": init_mlp(gen, cfg, device, n_layers=Le),
        "ln1_scale": zeros(Le, d),
        "ln2_scale": zeros(Le, d),
    }
    dec_layers = {
        "self_attn": attn.init_attention(gen, cfg, device, n_layers=Ld),
        "cross_attn": attn.init_attention(gen, cfg, device, n_layers=Ld),
        "mlp": init_mlp(gen, cfg, device, n_layers=Ld),
        "ln1_scale": zeros(Ld, d),
        "ln2_scale": zeros(Ld, d),
        "ln3_scale": zeros(Ld, d),
    }
    return {
        "frontend_proj": dense_init(gen, (d, d), dtype=pd, device=device),  # conv stub -> d
        "encoder": {"layers": enc_layers, "final_norm_scale": zeros(d)},
        "embed": embed_init(gen, (cfg.vocab, d), dtype=pd, device=device),
        "decoder": {"layers": dec_layers, "final_norm_scale": zeros(d)},
        "head": dense_init(gen, (d, cfg.vocab), fan_in=d, dtype=pd, device=device),
    }


def _enc_layer(cfg: ModelConfig, x: torch.Tensor, lp: Tree,
               positions: torch.Tensor) -> torch.Tensor:
    x = x + attn.attend(lp["attn"], cfg, rms_norm(x, lp["ln1_scale"]), positions, causal=False)
    return x + mlp(lp["mlp"], cfg, rms_norm(x, lp["ln2_scale"]))


def encode(cfg: ModelConfig, params: Tree, frames: torch.Tensor) -> torch.Tensor:
    """frames [B, F, d] (the frontend stub's input) -> encoder states [B, F, d]."""
    dt = cfg.compute_dtype
    x = frames.to(dt) @ params["frontend_proj"].to(dt)
    F = x.shape[1]
    x = x + sinusoidal_positions(F, cfg.d_model, x.device).to(dt)[None]
    positions = torch.arange(F, device=x.device)
    for lp in _unstack(params["encoder"]["layers"], _n_encoder(cfg)):
        if cfg.remat:
            x = remat(lambda x, lp=lp: _enc_layer(cfg, x, lp, positions), x)
        else:
            x = _enc_layer(cfg, x, lp, positions)
    return rms_norm(x, params["encoder"]["final_norm_scale"])


def _dec_layer(cfg: ModelConfig, x: torch.Tensor, enc: torch.Tensor, lp: Tree,
               positions: torch.Tensor) -> torch.Tensor:
    x = x + attn.attend(lp["self_attn"], cfg, rms_norm(x, lp["ln1_scale"]), positions)
    x = x + attn.cross_attend(lp["cross_attn"], cfg, rms_norm(x, lp["ln2_scale"]), enc)
    return x + mlp(lp["mlp"], cfg, rms_norm(x, lp["ln3_scale"]))


def _head(cfg: ModelConfig, params: Tree, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["decoder"]["final_norm_scale"])
    return x @ params["head"].to(cfg.compute_dtype)


def forward_whisper(cfg: ModelConfig, params: Tree, tokens: torch.Tensor,
                    context: torch.Tensor | None = None, last_only: bool = False,
                    hidden_only: bool = False, **_) -> tuple[torch.Tensor, torch.Tensor]:
    """Training forward: tokens [B, S], context = audio frame embeddings
    [B, F, d] -> (logits [B, S, V] (the final-normed hidden states with
    ``hidden_only``), aux 0)."""
    assert context is not None, "whisper forward requires audio context"
    enc = encode(cfg, params, context)
    x = _embed(cfg, params, tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    for lp in _unstack(params["decoder"]["layers"], cfg.n_layers):
        if cfg.remat:
            x = remat(lambda x, enc, lp=lp: _dec_layer(cfg, x, enc, lp, positions), x, enc)
        else:
            x = _dec_layer(cfg, x, enc, lp, positions)
    if last_only:
        x = x[:, -1:]
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if hidden_only:
        return rms_norm(x, params["decoder"]["final_norm_scale"]), zero
    return _head(cfg, params, x), zero


def init_cache_whisper(cfg: ModelConfig, params: Tree, batch: int, cache_len: int) -> Tree:
    """{"self": the decoder's dense KV cache [Ld, B, cache_len, KV, hd],
    "cross_k", "cross_v": [Ld, B, n_audio_frames, KV, hd] zeros, filled by
    :func:`fill_context_whisper`}."""
    device = params["embed"].device
    shape = (cfg.n_layers, batch, cfg.n_audio_frames, cfg.n_kv_heads, cfg.hd)
    return {
        "self": attn.init_cache(cfg, batch, cache_len, cfg.n_layers, device),
        "cross_k": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
        "cross_v": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
    }


def fill_context_whisper(cfg: ModelConfig, params: Tree, cache: Tree,
                         context: torch.Tensor) -> Tree:
    """Condition a decode cache on the audio context, in place: run the
    encoder once and write every decoder layer's cross-attention K/V.
    Without it the cross K/V stay zero and decode runs unconditioned; the
    serving paths call it (``Model.fill_context``) before the first step."""
    enc = encode(cfg, params, context)
    ca = params["decoder"]["layers"]["cross_attn"]
    for i in range(cfg.n_layers):
        k, v = attn.cross_kv(_layer(ca, i), cfg, enc)
        cache["cross_k"][i].copy_(k)
        cache["cross_v"][i].copy_(v)
    return cache


def decode_step_whisper(cfg: ModelConfig, params: Tree, cache: Tree, token: torch.Tensor,
                        pos: int, **_) -> tuple[torch.Tensor, Tree]:
    """One decode step. token [B] int; cache from :func:`init_cache_whisper`
    after :func:`fill_context_whisper` (its self cache written in place);
    ``pos`` the token's position. Returns (logits [B, V], cache)."""
    x = _embed(cfg, params, token[:, None])
    for i in range(cfg.n_layers):
        lp = _layer(params["decoder"]["layers"], i)
        h, _ = attn.attend_decode(lp["self_attn"], cfg, rms_norm(x, lp["ln1_scale"]),
                                  _layer(cache["self"], i), pos)
        x = x + h
        x = x + attn.cross_attend(lp["cross_attn"], cfg, rms_norm(x, lp["ln2_scale"]),
                                  (cache["cross_k"][i], cache["cross_v"][i]))
        x = x + mlp(lp["mlp"], cfg, rms_norm(x, lp["ln3_scale"]))
    return _head(cfg, params, x)[:, 0], cache
