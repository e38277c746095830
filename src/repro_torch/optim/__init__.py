"""Optimizer substrate of the port: AdamW and its schedule (port of
``repro.optim``)."""
from . import adamw, schedule
from .adamw import AdamWConfig, AdamWState

__all__ = ["adamw", "schedule", "AdamWConfig", "AdamWState"]
