"""kimi-k2-1t-a32b [moe] — trillion-param MoE, 384 experts top-8 + 1 shared.

[arXiv:2501.kimi2] (paper-table). Per-expert d_ff=2048 (fine-grained); 64:8
heads of 112. 1.044T parameters; a layer holds 17.07B, 16.91B of them the
routed expert bank: one H100 holds one layer with all 384 experts in bf16
(19.42B with the embedding and the untied head, 38.8 GB).
"""
from repro_torch.configs.base import register
from repro_torch.models.common import ModelConfig

CONFIG = register(ModelConfig(
    name="kimi-k2-1t-a32b",
    arch_type="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,  # GQA
    head_dim=112,
    d_ff=2048,  # per routed expert
    vocab=163840,
    n_experts=384,
    experts_per_token=8,
    n_shared_experts=1,
    capacity_factor=1.25,
    citation="[arXiv:2501.kimi2]",
))
