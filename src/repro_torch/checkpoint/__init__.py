"""Checksummed checkpoints (port of ``repro/checkpoint``)."""
from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    CheckpointError,
    checkpoint_path,
    list_checkpoints,
    load_checkpoint,
    load_latest_valid,
    read_manifest,
    save_checkpoint,
    save_round_checkpoint,
)
