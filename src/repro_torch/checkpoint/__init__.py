"""Atomic, keep-N checkpoints in the JAX package's on-disk layout."""
from .store import (
    CheckpointManager,
    latest_step,
    load_checkpoint,
    restore_state,
    save_checkpoint,
)

__all__ = [
    "CheckpointManager",
    "latest_step",
    "load_checkpoint",
    "restore_state",
    "save_checkpoint",
]
