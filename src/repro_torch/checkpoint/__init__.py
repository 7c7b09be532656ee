"""Checkpoint store in the JAX package's on-disk format."""
from .store import COMMITTED, CheckpointStore

__all__ = ["COMMITTED", "CheckpointStore"]
