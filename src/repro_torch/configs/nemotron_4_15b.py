"""nemotron-4-15b [dense] — GQA + squared-ReLU FFN, arXiv:2402.16819."""
from repro_torch.configs.base import register
from repro_torch.models.common import ModelConfig

CONFIG = register(ModelConfig(
    name="nemotron-4-15b",
    arch_type="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,  # GQA
    head_dim=128,
    d_ff=24576,
    vocab=256000,
    activation="relu2",  # squared ReLU
    qk_norm=False,
    rope_theta=10_000.0,
    citation="[arXiv:2402.16819]",
))
