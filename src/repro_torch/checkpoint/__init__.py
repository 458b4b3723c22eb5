"""Checkpoints of trees of tensors (mirror of ``repro.checkpoint``)."""
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
