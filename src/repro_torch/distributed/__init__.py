"""Distributed Dash on ``torch.distributed``: one shard per rank, keys
routed to their owners by ``all_to_all_single`` (port of
``repro.distributed``)."""
from .dht import (DistributedDash, ShardFrontend, auto_capacity, build_dht_programs,
                  make_sharded_state, np_owner_of, owner_of)

__all__ = ["DistributedDash", "ShardFrontend", "auto_capacity", "build_dht_programs",
           "make_sharded_state", "np_owner_of", "owner_of"]
