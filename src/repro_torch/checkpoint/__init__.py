"""Checkpoint substrate of the port: atomic commits + instant recovery (Dash
Sec. 4.8), in the reference's format (port of ``repro.checkpoint``)."""
from .manager import CheckpointManager, LazyTensor

__all__ = ["CheckpointManager", "LazyTensor"]
