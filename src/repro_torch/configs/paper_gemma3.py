"""The paper's own Gemma3-style scaling ladder (Tab. 1), port of
``repro/configs/paper_gemma3.py``.

SwiGLU FFNs, QK-norm, extra RMSNorm before residual connections (post-norms),
Llama3 tokenizer (vocab 128256), seq 2048. "QKV Dimension" = d_model,
"Hidden Dimension" = d_ff. Every rung is full multi-head attention with
head dim 128 and an untied head.
"""
from repro_torch.configs.base import register
from repro_torch.models.common import ModelConfig


def _ladder(name, n_layers, n_heads, d_model, d_ff):
    return register(ModelConfig(
        name=name,
        arch_type="dense",
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_heads,
        head_dim=d_model // n_heads,
        d_ff=d_ff,
        vocab=128256,
        activation="swiglu",
        qk_norm=True,
        post_norm=True,
        citation="[paper Tab. 1, Gemma3-style / arXiv:2503.19786]",
    ))


PAPER_150M = _ladder("paper-150m", 6, 4, 512, 1408)
PAPER_416M = _ladder("paper-416m", 12, 8, 1024, 2816)
PAPER_914M = _ladder("paper-914m", 18, 12, 1536, 4224)
PAPER_1_76B = _ladder("paper-1.76b", 24, 16, 2048, 5632)
PAPER_3_07B = _ladder("paper-3.07b", 30, 20, 2560, 7040)
PAPER_15B = _ladder("paper-15.23b", 54, 36, 4608, 12672)
