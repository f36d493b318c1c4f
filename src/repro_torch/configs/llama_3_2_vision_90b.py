"""llama-3.2-vision-90b [vlm] — cross-attn image layers every 5th layer.

hf:meta-llama/Llama-3.2-11B-Vision (90B scale-up). ViT encoder + projector
stubbed; the context supplies patch embeddings [B, 1600, d].
"""
from repro_torch.configs.base import register
from repro_torch.models.common import ModelConfig

CONFIG = register(ModelConfig(
    name="llama-3.2-vision-90b",
    arch_type="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,  # GQA
    head_dim=128,
    d_ff=28672,
    vocab=128256,
    vlm_period=5,  # 20 gated cross-attn layers among 100
    n_image_tokens=1600,
    rope_theta=500_000.0,
    citation="[hf:meta-llama/Llama-3.2-11B-Vision]",
))
