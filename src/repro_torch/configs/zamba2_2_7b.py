"""zamba2-2.7b [hybrid] — Mamba2 backbone + one shared attention block
invoked every 6 layers, arXiv:2411.15242."""
from repro_torch.configs.base import register
from repro_torch.models.common import ModelConfig

CONFIG = register(ModelConfig(
    name="zamba2-2.7b",
    arch_type="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=10240,  # shared attention block's MLP
    vocab=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    hybrid_period=6,  # 9 superblocks of (shared attn + 6 mamba layers)
    sliding_window=4096,  # shared attn uses a window so long_500k stays sub-quadratic
    citation="[arXiv:2411.15242]",
))
