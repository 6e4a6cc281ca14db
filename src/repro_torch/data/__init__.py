"""Data for the port: the partitioned graph store and its sampler, and
the synthetic token stream of LM training."""
from .graph import PartitionedGraph, sample_blocks, sample_support, synthetic_graph
from .pipeline import TokenPipeline

__all__ = ["PartitionedGraph", "TokenPipeline", "sample_blocks", "sample_support",
           "synthetic_graph"]
