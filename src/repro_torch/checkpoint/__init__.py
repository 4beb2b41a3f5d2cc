"""Checkpoints of the port, in the reference's on-disk format."""
from repro_torch.checkpoint.manager import CheckpointManager, path_str

__all__ = ["CheckpointManager", "path_str"]
