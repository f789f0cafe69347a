"""Checkpointing: the disk tier (``store.py``, with ZeRO-1 slices under a data
mesh and the elastic ``restore_resharded``) and the host-RAM tier with peer
mirrors (``memory.py``), in the reference's on-disk format."""

from .memory import MemoryCheckpointTier
from .store import CheckpointManager, CorruptCheckpointError

__all__ = ["CheckpointManager", "CorruptCheckpointError", "MemoryCheckpointTier"]
