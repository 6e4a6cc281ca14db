"""Graph data for the port: the partitioned graph store and its sampler."""
from .graph import PartitionedGraph, sample_blocks, sample_support, synthetic_graph

__all__ = ["PartitionedGraph", "sample_blocks", "sample_support", "synthetic_graph"]
