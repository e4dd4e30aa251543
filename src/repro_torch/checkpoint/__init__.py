"""Checkpoints in the reference's on-disk format."""

from repro_torch.checkpoint.manager import CheckpointManager  # noqa: F401
