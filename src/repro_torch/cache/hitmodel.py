"""Hit-rate model: the bridge from trace replay to the planning loop.

ETP evaluates thousands of candidate placements; replaying a cache trace
per candidate would dwarf the simulation cost it is meant to refine.  The
``HitModel`` therefore precomputes (lazily, memoised) per-iteration hit
rates as a function of the only placement-dependent quantity — the number
``k`` of samplers sharing one machine's cache — so the volume-rewriting
layer reduces to a table lookup and a multiply.

Also here:

  * ``static_hit_rate_estimate`` — the closed-form companion of the
    ``static`` policy: with per-sampler-iteration touch probabilities
    ``p_v`` (hotness), a prefilled top-C cache serves an expected fraction
    ``sum_{top-C} p_v / sum_v p_v`` of fetches.  The trace replay must
    agree with this within Monte-Carlo tolerance (tested on the synthetic
    graph) — the estimator is what lets capacity sweeps run without
    re-replaying the trace per point.
  * ``hit_model_for_profile`` — dataset profiles (profiles.py) describe
    graphs we cannot hold in memory; a size-scaled synthetic proxy graph
    with the profile's fan-outs supplies the reuse structure, and cache
    capacities in GB are mapped to proxy-node counts through the
    real-graph byte-per-node figure and the proxy/real node ratio.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from ..core.profiles import DatasetProfile
from ..core.units import BYTES_PER_GB, GB, Ratio

from ..data.graph import synthetic_graph
from .policies import replay
from .trace import AccessTrace, collect_trace

# steady-state tail: iterations beyond the trace horizon reuse the mean of
# this many final trace iterations (warm regime has stabilised by then)
TAIL_ITERS = 4


@dataclass
class HitModel:
    """Per-(sharing-degree, iteration) hit-rate table for one cache size.

    ``warm_iters`` shifts the replay's origin: a model with
    ``warm_iters=w`` reports the hit rates of iterations ``w+1 .. w+n`` of
    the SAME continuous replay — i.e. a cache that has already served ``w``
    iterations and kept its state.  Incremental re-planning
    (repro_torch.dynamics.replan) carries this across plan intervals via
    ``warm_started`` instead of pretending every re-plan starts cold."""

    trace: AccessTrace
    policy: str
    capacity_nodes: int
    warm_iters: int = 0
    _table: Dict[int, np.ndarray] = field(default_factory=dict)

    def hit_rates(self, k: int, n_iters: int) -> np.ndarray:
        """[n_iters] hit fractions for a cache shared by ``k`` samplers,
        starting ``warm_iters`` iterations into the replay.

        Replayed on demand and memoised per ``k`` (a search touches only a
        handful of distinct sharing degrees).  Horizons longer than the
        trace are extended with the steady-state tail mean.  ``k`` beyond
        the trace's sampler count clamps to the widest recorded group —
        warned once, because the clamped curve understates LRU capacity
        pressure and prefetch-buffer dilution; collect a trace with at
        least as many samplers as the job to avoid it."""
        if int(k) > self.trace.n_samplers:
            warnings.warn(
                f"cache sharing degree k={int(k)} exceeds the trace's "
                f"{self.trace.n_samplers} samplers; clamping to the widest "
                "recorded group (hit rates will be optimistic)",
                stacklevel=2,
            )
        k = max(1, min(int(k), self.trace.n_samplers))
        got = self._table.get(k)
        if got is None:
            got = replay(self.trace, self.policy, self.capacity_nodes, k)
            self._table[k] = got
        total = self.warm_iters + n_iters
        if total <= len(got):
            return got[self.warm_iters : total]
        tail = float(got[-TAIL_ITERS:].mean()) if len(got) else 0.0
        full = np.concatenate([got, np.full(total - len(got), tail)])
        return full[self.warm_iters :]

    def warm_started(self, extra_iters: int) -> "HitModel":
        """The same cache after ``extra_iters`` more served iterations.
        Shares the memoised replay table — warm views are free."""
        if extra_iters < 0:
            raise ValueError("extra_iters must be >= 0")
        return HitModel(
            trace=self.trace,
            policy=self.policy,
            capacity_nodes=self.capacity_nodes,
            warm_iters=self.warm_iters + int(extra_iters),
            _table=self._table,
        )

    def mean_hit_rate(self, k: int = 1) -> Ratio:
        return float(self.hit_rates(k, self.trace.n_iters).mean())


def touch_probabilities(trace: AccessTrace, k: int = 1) -> np.ndarray:
    """[n_nodes] empirical per-sampler-iteration touch probability p_v."""
    cells = min(k, trace.n_samplers) * trace.n_iters
    return trace.touch_counts(k) / max(cells, 1)


def static_hit_rate_estimate(
    trace: AccessTrace, capacity_nodes: int, k: int = 1
) -> Ratio:
    """Closed-form expected hit fraction of a prefilled top-C hotness cache.

    Each iteration a sampler touches node v with probability p_v (at most
    once — support sets are deduplicated), so expected fetches land on the
    cached set in proportion to its share of total touch mass.  Sharing
    does not change the *fraction* for a prefilled static cache: k samplers
    multiply hits and accesses alike."""
    if capacity_nodes <= 0:
        return 0.0
    p = touch_probabilities(trace, k)
    order = np.argsort(p, kind="stable")[::-1]
    total = float(p.sum())
    if total <= 0:
        return 0.0
    return float(p[order[:capacity_nodes]].sum() / total)


def build_hit_model(
    trace: AccessTrace, *, policy: str = "lru", capacity_nodes: int
) -> HitModel:
    return HitModel(trace=trace, policy=policy, capacity_nodes=int(capacity_nodes))


def capacity_nodes_for_gb(
    cache_gb: GB, *, bytes_per_node: int, real_nodes: float, proxy_nodes: int
) -> int:
    """GB budget on the real graph -> node capacity in proxy-graph units.

    The proxy preserves the *fraction* of the graph a budget covers: C real
    feature rows out of ``real_nodes`` become the same fraction of
    ``proxy_nodes``."""
    real_capacity = cache_gb * BYTES_PER_GB / max(bytes_per_node, 1)
    frac = min(1.0, real_capacity / max(real_nodes, 1.0))
    return int(round(frac * proxy_nodes))


def cache_gb_for_capacity(
    capacity_nodes: int,
    *,
    bytes_per_node: int,
    real_nodes: Optional[float] = None,
    proxy_nodes: Optional[int] = None,
) -> GB:
    """Inverse of ``capacity_nodes_for_gb``: the memory a hit model's node
    capacity actually costs, in GB on the real graph.

    This is the bridge that keeps ``HitModel.capacity_nodes`` (what the
    hit rates assume is resident) and ``CacheConfig.cache_gb`` (what the
    placement search reserves per machine) consistent — derive one from
    the other instead of picking both by hand.  For a non-proxy trace,
    omit ``real_nodes``/``proxy_nodes``."""
    if (real_nodes is None) != (proxy_nodes is None):
        raise ValueError("give both real_nodes and proxy_nodes, or neither")
    n = float(capacity_nodes)
    if real_nodes is not None and proxy_nodes is not None:
        n = n / max(proxy_nodes, 1) * real_nodes
    return n * bytes_per_node / BYTES_PER_GB


def hit_model_for_profile(
    profile: DatasetProfile,
    *,
    cache_gb: GB,
    policy: str = "lru",
    n_samplers: int,
    batch_size: int = 2000,
    samplers_per_worker: int = 2,
    n_iters: int = 24,
    proxy_nodes: int = 6000,
    avg_degree: int = 16,
    seed: int = 0,
    trace: Optional[AccessTrace] = None,
) -> HitModel:
    """Hit model for a dataset profile via a size-scaled synthetic proxy.

    Seeds per sampler-iteration scale with the node ratio so per-batch
    coverage of the graph (the quantity reuse rates depend on) matches the
    real job; fan-outs and feature width come from the profile.  Pass a
    precollected ``trace`` to sweep many (policy, cache_gb) points without
    re-sampling."""
    if trace is None:
        trace = collect_profile_trace(
            profile,
            n_samplers=n_samplers,
            batch_size=batch_size,
            samplers_per_worker=samplers_per_worker,
            n_iters=n_iters,
            proxy_nodes=proxy_nodes,
            avg_degree=avg_degree,
            seed=seed,
        )
    cap = capacity_nodes_for_gb(
        cache_gb,
        bytes_per_node=profile.feature_len * 4,
        real_nodes=profile.n_nodes,
        proxy_nodes=trace.n_nodes,
    )
    return build_hit_model(trace, policy=policy, capacity_nodes=cap)


def collect_profile_trace(
    profile: DatasetProfile,
    *,
    n_samplers: int,
    batch_size: int = 2000,
    samplers_per_worker: int = 2,
    n_iters: int = 24,
    proxy_nodes: int = 6000,
    avg_degree: int = 16,
    seed: int = 0,
) -> AccessTrace:
    """Collect one proxy trace usable by every cache size/policy sweep."""
    g = synthetic_graph(
        n_nodes=proxy_nodes,
        avg_degree=avg_degree,
        n_feats=min(profile.feature_len, 16),  # trace ignores feature values
        n_parts=4,
        seed=seed,
    )
    seeds_real = batch_size // samplers_per_worker
    seeds_proxy = max(2, int(round(seeds_real * proxy_nodes / profile.n_nodes)))
    return collect_trace(
        g,
        n_samplers=n_samplers,
        seeds_per_iter=seeds_proxy,
        fanouts=tuple(profile.fanout),
        n_iters=n_iters,
        seed=seed,
        # the proxy stores narrow features for speed; byte<->node
        # conversions must use the real dataset's row width
        bytes_per_node=profile.feature_len * 4,
    )
