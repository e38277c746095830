"""Workload generators that drive the serving frontend end-to-end."""
from . import ycsb
from .ycsb import MIXES, YCSBConfig, generate, load_keys, zipfian_ranks

__all__ = ["ycsb", "MIXES", "YCSBConfig", "generate", "load_keys",
           "zipfian_ranks"]
