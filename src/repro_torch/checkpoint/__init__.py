"""Checkpointing, single process: the disk tier (``store.py``) and the host-RAM
tier with peer mirrors (``memory.py``), in the reference's on-disk format."""

from .memory import MemoryCheckpointTier
from .store import CheckpointManager, CorruptCheckpointError

__all__ = ["CheckpointManager", "CorruptCheckpointError", "MemoryCheckpointTier"]
