"""Dash in PyTorch — core hash-table library (port of ``repro.core``).

Public API:
    DashConfig           static configuration / feature flags
    DashEH               host-facing extendible-hashing table
    DashLH               host-facing linear-hashing table
    make_state           raw state constructor
    engine               batched ops (insert/search/delete/update)

Tables and states live on the card unless ``device`` names another
(``device="cpu"`` for CPU runs).
"""
from .layout import (DashConfig, DashState, make_state, load_factor,
                     INSERTED, EXISTS, NEED_SPLIT, DROPPED, NOT_FOUND)
from .table import DashEH, DashLH, DashTable, TableFullError
from . import (bucket, dash_eh, dash_lh, engine, epoch, hashing, layout,
               recovery, smo)

__all__ = [
    "DashConfig", "DashState", "make_state", "load_factor",
    "DashEH", "DashLH", "DashTable", "TableFullError",
    "INSERTED", "EXISTS", "NEED_SPLIT", "DROPPED", "NOT_FOUND",
    "bucket", "dash_eh", "dash_lh", "engine", "epoch", "hashing", "layout", "recovery",
    "smo",
]
