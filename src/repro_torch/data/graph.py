"""In-memory partitioned graph store + fixed-fanout neighbor sampler.

The port's copy of the JAX package's ``repro.data.graph`` (numpy only):
the graph is hash-partitioned over M stores, each sampler issues
per-iteration requests, and the returned per-store byte counts calibrate
the DGTP traffic model (examples/train_graphsage_torch.py).  The copy
makes the same ``np.random.Generator`` calls in the same order, so at
equal seeds the graph, the blocks, the labels and the per-store bytes
equal the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np


@dataclass
class PartitionedGraph:
    """CSR graph with features, hash-partitioned over n_parts stores."""

    indptr: np.ndarray  # [N+1]
    indices: np.ndarray  # [E]
    feats: np.ndarray  # [N, F] float32
    labels: np.ndarray  # [N] int64
    train_nodes: np.ndarray
    n_parts: int

    @property
    def n_nodes(self) -> int:
        return len(self.indptr) - 1

    def part_of(self, nodes: np.ndarray) -> np.ndarray:
        return nodes % self.n_parts


def synthetic_graph(
    n_nodes: int = 20_000,
    avg_degree: int = 16,
    n_feats: int = 100,
    n_classes: int = 47,
    n_parts: int = 4,
    train_frac: float = 0.1,
    seed: int = 0,
) -> PartitionedGraph:
    """Power-law-ish random graph with community-correlated labels/features
    (so GraphSAGE actually learns: features = class centroid + noise)."""
    rng = np.random.default_rng(seed)
    deg = np.clip(rng.zipf(1.7, n_nodes), 1, 10 * avg_degree)
    deg = (deg * (avg_degree / deg.mean())).astype(np.int64).clip(1)
    indptr = np.concatenate([[0], np.cumsum(deg)])
    labels = rng.integers(0, n_classes, n_nodes)
    # homophily: neighbors prefer same-class nodes
    by_class = [np.where(labels == c)[0] for c in range(n_classes)]
    indices = np.empty(indptr[-1], dtype=np.int64)
    for v in range(n_nodes):
        k = deg[v]
        same = by_class[labels[v]]
        n_same = int(k * 0.7)
        pick_same = same[rng.integers(0, len(same), n_same)] if len(same) else rng.integers(0, n_nodes, n_same)
        pick_rand = rng.integers(0, n_nodes, k - n_same)
        indices[indptr[v] : indptr[v + 1]] = np.concatenate([pick_same, pick_rand])
    centroids = rng.normal(0, 1, (n_classes, n_feats))
    feats = (centroids[labels] + rng.normal(0, 1.0, (n_nodes, n_feats))).astype(
        np.float32
    )
    train = rng.choice(n_nodes, int(train_frac * n_nodes), replace=False)
    return PartitionedGraph(
        indptr=indptr, indices=indices, feats=feats, labels=labels,
        train_nodes=train, n_parts=n_parts,
    )


def sample_support(
    g: PartitionedGraph,
    seeds: np.ndarray,
    fanouts: Sequence[int],
    rng: np.random.Generator,
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Layer expansion of fixed-fanout recursive sampling (paper §II-A).

    Returns (layers, blocks): ``layers[l]`` are the unique node ids of layer
    ``l`` (seed-first layout, ``layers[-1]`` is the full support set whose
    features must be fetched), ``blocks[l]`` maps layer-l target nodes to
    positions in layer-(l+1) nodes.  ``sample_blocks`` materialises features
    on top of this.
    """
    layers = [seeds.astype(np.int64)]
    blocks: List[np.ndarray] = []
    for k in fanouts:
        targets = layers[-1]
        uniq: Dict[int, int] = {int(v): i for i, v in enumerate(targets)}
        nodes = list(targets)
        idx = np.full((len(targets), k), -1, dtype=np.int32)
        for i, v in enumerate(targets):
            lo, hi = g.indptr[v], g.indptr[v + 1]
            if hi <= lo:
                continue
            nbrs = g.indices[lo + rng.integers(0, hi - lo, k)]
            for j, u in enumerate(nbrs):
                u = int(u)
                if u not in uniq:
                    uniq[u] = len(nodes)
                    nodes.append(u)
                idx[i, j] = uniq[u]
        layers.append(np.asarray(nodes, dtype=np.int64))
        blocks.append(idx)
    return layers, blocks


def sample_blocks(
    g: PartitionedGraph,
    seeds: np.ndarray,
    fanouts: Sequence[int],
    rng: np.random.Generator,
) -> Tuple[np.ndarray, List[np.ndarray], np.ndarray, Dict[int, int]]:
    """Fixed-fanout recursive sampling (paper §II-A).

    Returns (feats [n_L, F], blocks [idx per layer, seed-first layout],
    labels [n_seeds], per_store_bytes {store: bytes fetched}).
    blocks[l] maps layer-l target nodes to positions in layer-(l+1) nodes.
    """
    layers, blocks = sample_support(g, seeds, fanouts, rng)
    support = layers[-1]
    feats = g.feats[support]
    labels = g.labels[seeds]
    parts = g.part_of(support)
    bytes_per_node = g.feats.shape[1] * 4
    per_store = {
        int(p): int((parts == p).sum()) * bytes_per_node for p in np.unique(parts)
    }
    return feats, blocks, labels.astype(np.int64), per_store
