"""Serving layer of the port: the online-resize concurrent frontend over a
Dash table and the optimistic snapshot search it reads through."""
from . import engine, frontend
from .engine import buckets_changed, snapshot_search
from .frontend import (AdmissionQueue, BatchFormer, DashFrontend, Op,
                       StopTheWorldFrontend)

__all__ = ["engine", "frontend", "snapshot_search", "buckets_changed",
           "AdmissionQueue", "BatchFormer", "DashFrontend", "Op",
           "StopTheWorldFrontend"]
