"""Serving layer of the port: the LM serving engine over the Dash prefix
cache and the paged KV pool, the online-resize concurrent frontend over a
Dash table, and the optimistic snapshot search it reads through."""
from . import engine, frontend, kv_cache, prefix_cache
from .engine import Request, ServingEngine, buckets_changed, snapshot_search
from .frontend import (AdmissionQueue, BatchFormer, DashFrontend, Op,
                       StopTheWorldFrontend)
from .prefix_cache import BLOCK, DashPrefixCache

__all__ = ["engine", "frontend", "kv_cache", "prefix_cache", "Request",
           "ServingEngine", "snapshot_search", "buckets_changed",
           "AdmissionQueue", "BatchFormer", "DashFrontend", "Op",
           "StopTheWorldFrontend", "BLOCK", "DashPrefixCache"]
