"""mistral-large-123b [dense] — hf:mistralai/Mistral-Large-Instruct-2407.

88 layers, d 12288, 96:8 heads of 128 (G = 12), SwiGLU d_ff 28672, vocab
32,768, rope theta 1e6. About 122.6B parameters (1.384B a layer): one H100
serves it with bf16 weights at a cut depth.
"""
from repro_torch.configs.base import register
from repro_torch.models.common import ModelConfig

CONFIG = register(ModelConfig(
    name="mistral-large-123b",
    arch_type="dense",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,  # GQA
    head_dim=128,
    d_ff=28672,
    vocab=32768,
    activation="swiglu",
    qk_norm=False,
    rope_theta=1_000_000.0,
    citation="[hf:mistralai/Mistral-Large-Instruct-2407]",
))
