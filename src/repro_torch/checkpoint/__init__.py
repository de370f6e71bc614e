"""Checkpoints in the reference's format (counterpart of
``repro.checkpoint``)."""
from repro_torch.checkpoint.store import CheckpointStore

__all__ = ["CheckpointStore"]
