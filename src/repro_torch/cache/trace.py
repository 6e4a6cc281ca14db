"""Trace collection: which node features does each sampler touch, when?

The planner's traffic profiles treat per-iteration store->sampler volumes
as fixed constants, but the bytes a sampler actually pulls are *feature
rows of specific nodes* — and mini-batch sampling revisits hot nodes
constantly (power-law degree => the same high-degree vertices appear in
almost every batch).  A feature cache exploits exactly that reuse, so the
first thing the cache layer needs is the ground-truth access sequence.

``collect_trace`` replays ``repro_torch.data.graph.sample_support`` (the
layer expansion inside ``sample_blocks``, equal to the JAX package's
sampler draw for draw) once per sampler per iteration and
records the unique support-node set of every mini-batch.  Everything
downstream — policy replay (policies.py), the closed-form estimator and
the hit-rate tables (hitmodel.py) — is pure array work over this trace,
so one trace serves every (policy, capacity, sharing-degree) combination.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from ..data.graph import PartitionedGraph, sample_support


@dataclass
class AccessTrace:
    """Per-sampler, per-iteration unique node-feature fetch sets.

    ``accesses[s][n]`` holds the (deduplicated, order-of-discovery) node ids
    whose features sampler ``s`` needs for its iteration-``n`` mini-batch.
    ``n_nodes`` / ``bytes_per_node`` tie node counts back to byte volumes.
    """

    accesses: List[List[np.ndarray]]  # [S][N] int64 arrays
    n_nodes: int
    bytes_per_node: int

    @property
    def n_samplers(self) -> int:
        return len(self.accesses)

    @property
    def n_iters(self) -> int:
        return len(self.accesses[0]) if self.accesses else 0

    def merged(self, k: int) -> List[List[np.ndarray]]:
        """Per-iteration access streams of the first ``k`` samplers — the
        interleaving seen by one shared cache hosting ``k`` colocated
        samplers (iteration-major, sampler order within an iteration)."""
        k = min(k, self.n_samplers)
        return [
            [self.accesses[s][n] for s in range(k)] for n in range(self.n_iters)
        ]

    def touch_counts(self, k: int = 1) -> np.ndarray:
        """[n_nodes] total touches over the trace by the first k samplers."""
        c = np.zeros(self.n_nodes, dtype=np.int64)
        for s in range(min(k, self.n_samplers)):
            for arr in self.accesses[s]:
                np.add.at(c, arr, 1)
        return c


def collect_trace(
    g: PartitionedGraph,
    *,
    n_samplers: int,
    seeds_per_iter: int,
    fanouts: Sequence[int],
    n_iters: int,
    seed: int = 0,
    bytes_per_node: Optional[int] = None,
) -> AccessTrace:
    """Replay ``sample_support`` for every (sampler, iteration) cell.

    Each sampler draws its own seed-node stream from ``g.train_nodes``
    (with replacement, matching the mini-batch construction in
    examples/train_graphsage_torch.py) and expands it with the job's
    fan-outs;
    the recorded set is ``layers[-1]`` — exactly the rows whose features
    the stores would ship.

    ``bytes_per_node`` defaults to the graph's own feature width; proxy
    traces standing in for a larger dataset (hitmodel.collect_profile_trace)
    override it with the REAL dataset's width so byte<->node conversions
    stay truthful even though the proxy stores narrower features."""
    accesses: List[List[np.ndarray]] = []
    for s in range(n_samplers):
        rng = np.random.default_rng(seed * 100_003 + s)
        mine: List[np.ndarray] = []
        for _ in range(n_iters):
            seeds = rng.choice(g.train_nodes, size=seeds_per_iter, replace=True)
            layers, _ = sample_support(g, seeds, fanouts, rng)
            support = layers[-1]
            # duplicate seed draws survive the layer expansion; one fetch
            # per node per batch, in discovery order
            _, first = np.unique(support, return_index=True)
            mine.append(support[np.sort(first)])
        accesses.append(mine)
    return AccessTrace(
        accesses=accesses,
        n_nodes=g.n_nodes,
        bytes_per_node=(
            int(bytes_per_node)
            if bytes_per_node is not None
            else int(g.feats.shape[1]) * 4
        ),
    )
