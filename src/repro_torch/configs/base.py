"""Config registry (port of ``repro/configs/base.py``).

Registered: every configuration of the reference. ``smollm-135m``, the
paper's Gemma3-style ladder (``paper-150m`` ... ``paper-15.23b``),
``nemotron-4-15b`` (relu2, 48:8 heads, served on one card with
``param_dtype='bfloat16'``), ``mistral-large-123b`` (96:8 heads of 128, G =
12), the MoE family's ``deepseek-moe-16b``, ``moonshot-v1-16b-a3b`` and
``kimi-k2-1t-a32b`` (64:8 heads of 112, 384 experts top-8), the SSM
family's ``mamba2-370m``, the hybrid ``zamba2-2.7b``, the audio family's
``whisper-large-v3`` and the VLM ``llama-3.2-vision-90b`` (64:8 heads of
128, G = 8); a name no package registers raises a ``KeyError`` that points
at ``ROADMAP.md``.
``reduce_config`` and ``InputShape`` are copied exactly, so
the port's reduced and full configs equal the reference's field for field.
The assigned input shapes (``INPUT_SHAPES``), the per-shape policy
(``config_for_shape``: the sliding window dense-family archs take on
``long_500k``), ``shape_supported`` and ``ASSIGNED_ARCHS`` equal the
reference's; the roofline's per-plan terms read them
(``repro_torch.roofline.terms.analytic_terms``).
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.common import ModelConfig

# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

LONG_CONTEXT_WINDOW = 8_192  # sliding window used by dense archs on long_500k


def config_for_shape(cfg: ModelConfig, shape: str) -> ModelConfig:
    """Per-shape architecture policy (the reference's DESIGN.md section 4)."""
    if shape == "long_500k" and cfg.arch_type in ("dense", "moe", "vlm"):
        # dense-family archs run the 524k decode only via the sub-quadratic
        # sliding-window variant
        return cfg.replace(sliding_window=LONG_CONTEXT_WINDOW)
    return cfg


def shape_supported(cfg: ModelConfig, shape: str) -> bool:
    return shape not in cfg.skip_shapes

# ---------------------------------------------------------------------------
# Reduced smoke-test variants
# ---------------------------------------------------------------------------


def reduce_config(cfg: ModelConfig) -> ModelConfig:
    """Same family, toy size: 2 layers/superblocks, d_model<=256, <=4 experts."""
    d = min(cfg.d_model, 256)
    heads = max(min(cfg.n_heads, 4), 1)
    kv = max(min(cfg.n_kv_heads, heads), 1)
    if heads % kv:
        kv = 1
    upd: dict = dict(
        d_model=d,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=d // heads,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab=min(cfg.vocab, 512),
        remat=False,
        dtype="float32",
        sliding_window=min(cfg.sliding_window, 16) if cfg.sliding_window else 0,
    )
    if cfg.arch_type == "hybrid":
        upd.update(n_layers=4, hybrid_period=2, ssm_state=16, ssm_head_dim=16, ssm_chunk=8)
    elif cfg.arch_type == "ssm":
        upd.update(n_layers=2, ssm_state=16, ssm_head_dim=16, ssm_chunk=8)
    elif cfg.arch_type == "vlm":
        upd.update(n_layers=4, vlm_period=2, n_image_tokens=16)
    elif cfg.arch_type == "audio":
        upd.update(n_layers=2, n_encoder_layers=2, n_audio_frames=16)
    else:
        upd.update(n_layers=2)
    if cfg.n_experts:
        upd.update(n_experts=4, experts_per_token=2, n_shared_experts=min(cfg.n_shared_experts, 1))
    return cfg.replace(**upd)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(
            f"arch {name!r} is not a registered configuration (registered: "
            f"{sorted(_REGISTRY)}); see ROADMAP.md for the port's slices")
    return _REGISTRY[name]


def list_configs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded():
    from repro_torch.configs import (  # noqa: F401
        deepseek_moe_16b,
        kimi_k2_1t_a32b,
        llama_3_2_vision_90b,
        mamba2_370m,
        mistral_large_123b,
        moonshot_v1_16b_a3b,
        nemotron_4_15b,
        paper_gemma3,
        smollm_135m,
        whisper_large_v3,
        zamba2_2_7b,
    )


ASSIGNED_ARCHS = (
    "mistral-large-123b",
    "mamba2-370m",
    "nemotron-4-15b",
    "kimi-k2-1t-a32b",
    "whisper-large-v3",
    "llama-3.2-vision-90b",
    "smollm-135m",
    "deepseek-moe-16b",
    "moonshot-v1-16b-a3b",
    "zamba2-2.7b",
)
