"""Atomic, asynchronous, self-pruning checkpoints in the reference's
``.npz`` format."""
from .manager import CheckpointManager, restore_tree, save_tree

__all__ = ["CheckpointManager", "save_tree", "restore_tree"]
