"""Volume rewriting: turn a Realization into its cache-adjusted counterpart.

The paper's DGTP model ships every sampled feature row from store to
sampler, every iteration.  With a feature cache on each sampler-hosting
machine, the bytes that actually cross the network shrink by the cache's
hit fraction — which depends on the iteration (caches warm up) and on the
*placement* (samplers colocated on one machine share that machine's cache
and its budget).  This module applies exactly that reshaping:

    vol'[e, n] = vol[e, n] * (1 - hit_k(m)[n])      for g2s edges
    vol'[e, n] = vol[e, n]                           otherwise

where ``m`` is the machine of edge ``e``'s destination sampler and
``k(m)`` the number of samplers placed on ``m``.  Sampler->worker,
gradient and parameter volumes are untouched: the cache serves *feature
fetches*, not the assembled mini-batch or the tensor traffic.

Because hit fractions live in [0, 1], adjusted volumes never exceed the
uncached ones (property-tested) — caching can only remove traffic.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Union

import numpy as np

from ..core.cluster import SAMPLER, ClusterSpec, Placement
from ..core.units import GB
from ..core.workload import Realization, Workload
from .hitmodel import HitModel


@dataclass(frozen=True)
class FeatureCacheConfig:
    """Deployment knobs of the feature-cache tier: the reference's
    ``CacheConfig`` (the name ``CacheConfig`` is an alias of this class).

    ``cache_gb`` is the budget a sampler-hosting machine dedicates to the
    (shared) feature cache: one float applies uniformly, a length-M
    sequence gives each machine its own budget — elastic clusters are
    heterogeneous by construction, so a machine that joins mid-run keeps
    whatever headroom it actually has.  ``reserve_mem`` couples the budget
    into placement search — ETP then trades sampler colocation
    (compounding hit rates) against the memory headroom the reservation
    consumes."""

    policy: str = "lru"
    cache_gb: Union[GB, Sequence[float]] = 1.0
    reserve_mem: bool = True

    def cache_gb_per_machine(self, n_machines: int) -> np.ndarray:
        """[M] budget vector (broadcast a scalar, validate a sequence)."""
        gb = np.asarray(self.cache_gb, dtype=np.float64)
        if gb.ndim == 0:
            return np.full(n_machines, float(gb))
        if gb.shape != (n_machines,):
            raise ValueError(
                f"cache_gb must be a scalar or length-{n_machines} sequence"
            )
        return gb.copy()


CacheConfig = FeatureCacheConfig


def sampler_ids(workload: Workload) -> np.ndarray:
    """Task indices of all samplers in the workload."""
    return np.array(
        [j for j, t in enumerate(workload.tasks) if t.kind == SAMPLER],
        dtype=np.int64,
    )


def _sampler_counts(y: np.ndarray, samplers: np.ndarray, n_machines: int) -> np.ndarray:
    return np.bincount(y[samplers], minlength=n_machines)


def samplers_per_machine(
    workload: Workload, cluster: ClusterSpec, placement: Placement
) -> np.ndarray:
    """[M] number of samplers placed on each machine."""
    return _sampler_counts(placement.y, sampler_ids(workload), cluster.M)


def g2s_edge_ids(workload: Workload) -> np.ndarray:
    return np.array(
        [i for i, e in enumerate(workload.edges) if e.kind == "g2s"],
        dtype=np.int64,
    )


class CacheRewriter:
    """Precompiled volume rewriter for one (workload, cluster, model).

    ETP evaluates thousands of candidate placements; everything that does
    not depend on the placement — edge ids, destination samplers, the
    sampler index set — is gathered once here so each ``adjust`` call is a
    bincount, a hit-curve lookup per distinct sharing degree, and one
    vectorised multiply."""

    def __init__(
        self,
        workload: Workload,
        cluster: ClusterSpec,
        model: HitModel,
        machine_models: Optional[Dict[int, HitModel]] = None,
    ) -> None:
        self.workload = workload
        self.cluster = cluster
        self.model = model
        # heterogeneous budgets: machine m's cache replays through
        # machine_models[m] when present (e.g. a smaller capacity_nodes on
        # a memory-poor machine), self.model otherwise
        self.machine_models = machine_models or {}
        self.g2s = g2s_edge_ids(workload)
        self.g2s_dst = workload.edge_dst[self.g2s]  # destination samplers
        self.samplers = sampler_ids(workload)

    def adjust(self, placement: Placement, realization: Realization) -> Realization:
        """Shrink g2s volumes by the placement-dependent per-iteration hit
        rate.  Exec times are untouched: the store/sampler compute profile
        already reflects the sampling work, which a cache does not remove."""
        n = realization.n_iters
        vol = realization.volumes.copy()
        k_of_m = _sampler_counts(placement.y, self.samplers, self.cluster.M)
        m_of_edge = placement.y[self.g2s_dst]  # [G] sampler machine
        k_of_edge = k_of_m[m_of_edge]
        if not self.machine_models:
            for kv in np.unique(k_of_edge):
                if kv <= 0:
                    continue
                miss = 1.0 - np.clip(self.model.hit_rates(int(kv), n), 0.0, 1.0)
                vol[self.g2s[k_of_edge == kv]] *= miss
        else:
            # group by (model-owning machine, sharing degree); machines
            # sharing the default model also share its memoised curves
            for m in np.unique(m_of_edge):
                model = self.machine_models.get(int(m), self.model)
                sel = m_of_edge == m
                kv = int(k_of_m[m])
                if kv <= 0:
                    continue
                miss = 1.0 - np.clip(model.hit_rates(kv, n), 0.0, 1.0)
                vol[self.g2s[sel]] *= miss
        return Realization(volumes=vol, exec_times=realization.exec_times)


def cache_adjusted_realization(
    workload: Workload,
    cluster: ClusterSpec,
    placement: Placement,
    realization: Realization,
    model: HitModel,
) -> Realization:
    """One-shot convenience wrapper around ``CacheRewriter.adjust``; inner
    loops (planner.cache_cost_fns) share a single rewriter instead."""
    return CacheRewriter(workload, cluster, model).adjust(placement, realization)
