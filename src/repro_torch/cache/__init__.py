"""Feature-cache subsystem: trace-driven caching/prefetch tier for DGTP.

A copy of the JAX package's ``repro.cache`` on the torch engine: the
same trace replay, hit tables and volume rewriting (numpy, exact), with
``device=`` in place of ``backend=`` wherever a simulation runs
(``cache_cost_fns``, ``cache_aware_etp``, ``cache_aware_plan``).

Mini-batch construction dominates distributed GNN training traffic, and a
large fraction of it is *redundant*: power-law graphs make samplers fetch
the same hot feature rows every iteration.  This package models the cache
tier that removes that redundancy and makes the planner aware of it:

  trace.py    — replay the port's sampler (data/graph.py) to record which
                node features each sampler touches, per iteration;
  policies.py — static hotness tiering (Data Tiering), shared LRU, and
                deterministic-sampling prefetch (RapidGNN) replays;
  hitmodel.py — memoised hit-rate tables keyed by cache-sharing degree,
                the closed-form static estimator, and dataset-profile
                proxies for graphs too large to materialise;
  adjust.py   — rewrite a Realization's store->sampler volumes by the
                placement-dependent per-iteration hit rates;
  planner.py  — cache-aware ETP: the MCMC search optimises the adjusted
                traffic and pays for per-machine cache reservations.
"""
from .adjust import (
    CacheConfig,
    CacheRewriter,
    FeatureCacheConfig,
    cache_adjusted_realization,
    g2s_edge_ids,
    sampler_ids,
    samplers_per_machine,
)
from .hitmodel import (
    HitModel,
    build_hit_model,
    cache_gb_for_capacity,
    capacity_nodes_for_gb,
    collect_profile_trace,
    hit_model_for_profile,
    static_hit_rate_estimate,
    touch_probabilities,
)
from .planner import (
    CachePlan,
    cache_aware_etp,
    cache_aware_plan,
    cache_cost_fns,
    cache_reservation_violation,
    make_reservation_fn,
)
from .policies import REPLAYS, replay, replay_lru, replay_prefetch, replay_static
from .trace import AccessTrace, collect_trace

__all__ = [k for k in dir() if not k.startswith("_")]
