"""moonshot-v1-16b-a3b — hf:moonshotai/Moonlight-16B-A3B.

A DeepSeek-style MoE (64 routed experts, top-6, 2 shared), as the
reference registers it. About 28.9B parameters, ~58 GB in bf16: held on the
CPU at reduced widths only.
"""
from repro_torch.configs.base import register
from repro_torch.models.common import ModelConfig

CONFIG = register(ModelConfig(
    name="moonshot-v1-16b-a3b",
    arch_type="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,  # per expert
    vocab=163840,
    n_experts=64,
    experts_per_token=6,
    n_shared_experts=2,
    citation="[hf:moonshotai/Moonlight-16B-A3B]",
))
