"""Distribution substrate of the port: logical-axis sharding rules, the
collectives over mesh axes, and gradient compression (port of
``repro.parallel``)."""
from . import collectives, compression, sharding

__all__ = ["sharding", "collectives", "compression"]
