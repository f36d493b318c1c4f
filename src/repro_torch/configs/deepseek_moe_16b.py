"""deepseek-moe-16b [moe] — 2 shared + 64 routed top-6, fine-grained experts.

arXiv:2401.06066. About 16.9B parameters (~33.8 GB in bf16): one H100 serves
it with bf16 weights; training on one card needs its depth cut.
"""
from repro_torch.configs.base import register
from repro_torch.models.common import ModelConfig

CONFIG = register(ModelConfig(
    name="deepseek-moe-16b",
    arch_type="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,  # per expert
    vocab=102400,
    n_experts=64,
    experts_per_token=6,
    n_shared_experts=2,
    rope_theta=10_000.0,
    citation="[arXiv:2401.06066]",
))
