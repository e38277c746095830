"""Data substrate of the port: synthetic sharded corpus, packing, Dash-LH
dedup (port of ``repro.data``)."""
from . import dedup, pipeline
from .pipeline import PackedBatcher, PipelineConfig, SyntheticCorpus
from .dedup import DedupFilter

__all__ = ["dedup", "pipeline", "PackedBatcher", "PipelineConfig",
           "SyntheticCorpus", "DedupFilter"]
