"""smollm-135m [dense] — llama-arch small, hf:HuggingFaceTB/SmolLM-135M."""
from repro_torch.configs.base import register
from repro_torch.models.common import ModelConfig

CONFIG = register(ModelConfig(
    name="smollm-135m",
    arch_type="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,  # GQA
    head_dim=64,
    d_ff=1536,
    vocab=49152,
    tie_embeddings=True,
    qk_norm=False,
    rope_theta=10_000.0,
    citation="[hf:HuggingFaceTB/SmolLM-135M]",
))
