"""Serving layer of the port: the online-resize concurrent frontend over a
Dash table, the optimistic snapshot search it reads through, and the Dash
prefix cache."""
from . import engine, frontend, prefix_cache
from .engine import buckets_changed, snapshot_search
from .frontend import (AdmissionQueue, BatchFormer, DashFrontend, Op,
                       StopTheWorldFrontend)
from .prefix_cache import BLOCK, DashPrefixCache

__all__ = ["engine", "frontend", "prefix_cache", "snapshot_search",
           "buckets_changed", "AdmissionQueue", "BatchFormer", "DashFrontend",
           "Op", "StopTheWorldFrontend", "BLOCK", "DashPrefixCache"]
