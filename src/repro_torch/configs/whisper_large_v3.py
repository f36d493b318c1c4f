"""whisper-large-v3 [audio] — enc-dec, conv frontend stubbed, arXiv:2212.04356.

32 encoder + 32 decoder layers at d=1280 (model card); MHA (kv == heads).
long_500k is skipped: a 524k-token decode is not meaningful for the 30 s /
448-token audio-decoder family.
"""
from repro_torch.configs.base import register
from repro_torch.models.common import ModelConfig

CONFIG = register(ModelConfig(
    name="whisper-large-v3",
    arch_type="audio",
    n_layers=32,           # decoder
    n_encoder_layers=32,   # encoder
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,  # MHA
    head_dim=64,
    d_ff=5120,
    vocab=51866,
    activation="gelu",
    qk_norm=False,
    n_audio_frames=1500,
    skip_shapes=("long_500k",),
    citation="[arXiv:2212.04356]",
))
