"""Shared model-definition building blocks (port of ``repro/models/common.py``).

Parameters are plain nested dicts of tensors with the reference's leaf paths
and its stacked ``[L, ...]`` layer layout, so trees cross between the two
packages by path (``repro_torch.utils.tree.params_from_numpy``). Where the
reference scans over the L axis, the port runs a Python loop.

The reference's ``shard_hint`` / ``activation_sharding`` are no-ops unless
mesh rules are installed; the port has no mesh yet, so they are left out.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    arch_type: str = "dense"  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 512
    vocab: int = 1024
    head_dim: int = 0  # 0 -> d_model // n_heads
    activation: str = "swiglu"  # swiglu | relu2 | gelu
    qk_norm: bool = True
    post_norm: bool = False  # gemma3-style extra RMSNorm after sublayer outputs
    rope_theta: float = 1_000_000.0
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_groups: int = 16
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 64
    conv_width: int = 4
    # hybrid (zamba2)
    hybrid_period: int = 6
    # vlm (llama-3.2-vision)
    vlm_period: int = 5
    n_image_tokens: int = 1600
    # audio (whisper)
    n_audio_frames: int = 1500
    n_encoder_layers: int = 0
    # attention variant
    sliding_window: int = 0  # 0 = full causal attention
    # attention execution backend: 'xla' (the plain torch path, named after
    # the reference's backend) or 'pallas' (the hand-written Hopper kernels)
    attn_impl: str = "xla"
    blockwise_threshold: int = 4096
    attn_block_q: int = 512
    attn_block_kv: int = 1024
    max_seq_len: int = 0
    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True
    # provenance / applicability
    citation: str = ""
    skip_shapes: tuple = ()

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(var + eps)
    return (normed * (1.0 + scale.float())).to(x.dtype)


def activation_fn(name: str, x: torch.Tensor, gate: torch.Tensor | None = None) -> torch.Tensor:
    if name == "swiglu":
        assert gate is not None
        return F.silu(gate) * x
    if name == "relu2":  # nemotron-4 squared ReLU
        return torch.square(F.relu(x))
    if name == "gelu":  # jax.nn.gelu defaults to the tanh approximation
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {name!r}")


def rope_frequencies(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding on split halves. x: [B, S, H, hd]; positions: [B, S] or [S]."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, device=x.device)  # [hd/2]
    if positions.ndim == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs  # [B, S, hd/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Initializers (standalone runs only: tests hand the reference's params over)
# ---------------------------------------------------------------------------

_TRUNC = 3.0


def _truncated_normal(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Standard normal truncated to [-3, 3] by inverting the CDF of a
    uniform draw (the same distribution as ``jax.random.truncated_normal``,
    not the same numbers)."""
    lo = 0.5 * (1.0 + math.erf(-_TRUNC / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(_TRUNC / math.sqrt(2.0)))
    u = torch.empty(shape, dtype=torch.float32, device=device).uniform_(lo, hi, generator=gen)
    x = torch.erfinv(2.0 * u - 1.0) * math.sqrt(2.0)
    return x.clamp_(-_TRUNC, _TRUNC)


def dense_init(gen: torch.Generator, shape, fan_in: int | None = None,
               dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    fan = fan_in if fan_in is not None else shape[-2]
    return (_truncated_normal(gen, shape, device) / math.sqrt(fan)).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype: torch.dtype = torch.float32,
               device=None) -> torch.Tensor:
    # std 1/sqrt(d): with the sqrt(d) input scaling this keeps the residual
    # stream O(1) AND keeps tied-embedding logits O(1).
    return (_truncated_normal(gen, shape, device) / math.sqrt(shape[-1])).to(dtype)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def _logz_and_gold(logits: torch.Tensor, labels: torch.Tensor):
    """fp32 logsumexp (max subtracted, not differentiated through) and the
    gold logit. The reference gathers the gold logit with a one-hot einsum
    (for a sharded vocab); on one card a gather gives the same value."""
    lmax = torch.amax(logits, dim=-1).detach()
    logz = lmax + torch.log(torch.sum(torch.exp(logits - lmax[..., None]), dim=-1))
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return logz, gold


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: torch.Tensor | None = None,
                          z_loss: float = 0.0) -> tuple[torch.Tensor, dict]:
    """Mean next-token cross-entropy in fp32. logits [B,S,V], labels [B,S]."""
    logz, gold = _logz_and_gold(logits.float(), labels)
    nll = logz - gold
    if z_loss:
        nll = nll + z_loss * torch.square(logz)
    mask = torch.ones_like(nll) if mask is None else mask.float()
    loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return loss, {"loss": loss, "tokens": torch.sum(mask)}


def _chunk_nll_sum(x_c: torch.Tensor, head_w: torch.Tensor, y_c: torch.Tensor) -> torch.Tensor:
    logz, gold = _logz_and_gold((x_c @ head_w.to(x_c.dtype)).float(), y_c)
    return torch.sum(logz - gold)


def fused_cross_entropy(hidden: torch.Tensor, head_w: torch.Tensor, labels: torch.Tensor,
                        chunk: int = 512) -> tuple[torch.Tensor, dict]:
    """Head matmul + cross-entropy per sequence chunk: the full [B, S, V]
    logits are never materialised. Each chunk's fp32 logits live only inside
    a ``torch.utils.checkpoint`` region (the reference's ``jax.checkpoint``),
    so the backward recomputes them instead of storing them.

    hidden [B, S, d] post-final-norm states; head_w [d, V]; labels [B, S].
    """
    B, S, _ = hidden.shape
    chunk = min(chunk, S)
    while S % chunk:
        chunk //= 2
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, S, chunk):
        x_c, y_c = hidden[:, i:i + chunk], labels[:, i:i + chunk]
        if torch.is_grad_enabled():
            part = checkpoint(_chunk_nll_sum, x_c, head_w, y_c, use_reentrant=False)
        else:
            part = _chunk_nll_sum(x_c, head_w, y_c)
        total = total + part
    loss = total / (B * S)
    return loss, {"loss": loss, "tokens": torch.tensor(float(B * S), device=hidden.device)}
