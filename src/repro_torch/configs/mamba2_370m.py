"""mamba2-370m [ssm] — SSD (state-space duality), arXiv:2405.21060."""
from repro_torch.configs.base import register
from repro_torch.models.common import ModelConfig

CONFIG = register(ModelConfig(
    name="mamba2-370m",
    arch_type="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=1,  # attention-free
    n_kv_heads=1,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,  # -> 32 SSD heads
    ssm_chunk=256,
    conv_width=4,
    citation="[arXiv:2405.21060]",
))
