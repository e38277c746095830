"""Training loop substrate of the port: composed steps + the fault-tolerant
trainer (port of ``repro.train``)."""
from . import steps

__all__ = ["steps"]
