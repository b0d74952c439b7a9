"""Checkpoint/restart in the reference's on-disk layout."""
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
