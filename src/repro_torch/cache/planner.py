"""Cache-aware placement search: ETP over the cache-adjusted traffic.

Cache-oblivious ETP optimises the wrong objective once a feature-cache
tier exists: it prices store->sampler flows at their uncached volumes,
overweighting store locality and ignoring that stacking samplers on one
machine compounds their shared-cache hit rate.  This module re-couples the
MCMC search (the lock-step ``etp_multichain``) to the cache model through
two hooks:

  * objective — every candidate placement's Monte-Carlo draws are rewritten
    by ``cache_adjusted_realization`` *for that candidate* before the
    batched simulation, so the search sees the traffic its own grouping of
    samplers would produce;
  * capacity  — the per-machine cache reservation (``CacheConfig.cache_gb``
    on every sampler-hosting machine) enters the cost's violation penalty
    via ``etp_search``'s ``extra_violation`` hook, making cache headroom a
    first-class resource the search trades against colocation.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.cluster import ClusterSpec, Placement
from ..core.engine import (
    DeviceLike,
    ScheduleResult,
    mean_batch_makespans,
    monte_carlo_draws,
)
from ..core.engine_torch import simulate_torch
from ..core.placement import ETPResult, etp_multichain
from ..core.workload import Realization, Workload
from .adjust import (
    CacheConfig,
    CacheRewriter,
    cache_adjusted_realization,
    sampler_ids,
)
from .hitmodel import HitModel


def make_reservation_fn(
    workload: Workload, cluster: ClusterSpec, config: CacheConfig
) -> Callable[[Placement], float]:
    """Precompiled ``extra_violation`` hook: placement -> extra violation
    fraction caused by the cache reservations alone.

    For each machine hosting >= 1 sampler, that machine's ``cache_gb``
    budget (scalar broadcast or per-machine vector — heterogeneous
    clusters reserve what each machine can actually spare) is reserved on
    top of task demands; the returned value is the *increase* in summed
    overflow fractions vs the unreserved usage (the base part is already
    charged by eq. 21's penalty inside ETP), so the two never
    double-count.  Everything placement-independent (demand memory column,
    sampler ids, capacity vectors) is gathered once here because ETP calls
    the hook for every evaluated candidate."""
    if not config.reserve_mem or "mem" not in cluster.resource_types:
        return lambda p: 0.0
    cache_gb = config.cache_gb_per_machine(cluster.M)
    if np.all(cache_gb <= 0):
        return lambda p: 0.0
    r = cluster.resource_types.index("mem")
    mem_demand = cluster.demand_matrix(workload.tasks)[:, r]
    samplers = sampler_ids(workload)
    mem_cap = cluster.cap[:, r]
    cap = np.where(mem_cap > 0, mem_cap, 1.0)

    def violation(placement: Placement) -> float:
        mem_use = np.bincount(
            placement.y, weights=mem_demand, minlength=cluster.M
        )
        hosts = np.zeros(cluster.M, dtype=bool)
        hosts[placement.y[samplers]] = True
        base = np.maximum((mem_use - mem_cap) / cap, 0.0)
        with_cache = np.maximum((mem_use + cache_gb * hosts - mem_cap) / cap, 0.0)
        return float((with_cache - base)[hosts].sum())

    return violation


def cache_reservation_violation(
    workload: Workload,
    cluster: ClusterSpec,
    config: CacheConfig,
    placement: Placement,
) -> float:
    """One-shot convenience wrapper around ``make_reservation_fn``."""
    return make_reservation_fn(workload, cluster, config)(placement)


def cache_cost_fns(
    workload: Workload,
    cluster: ClusterSpec,
    model: HitModel,
    *,
    sim_iters: int = 20,
    sim_draws: int = 1,
    seed: int = 0,
    policy: str = "oes",
    machine_models: Optional[Dict[int, HitModel]] = None,
    device: DeviceLike = None,
) -> Tuple[
    Callable[[Placement], float],
    Callable[[Sequence[Placement]], List[float]],
    List[Realization],
]:
    """(scalar_cost, batch_cost, draws): simulated makespan under the
    cache-adjusted traffic of each candidate placement.

    All candidates share one set of Monte-Carlo draws (apples-to-apples
    across the whole search) and ``batch_cost`` runs every pending
    (candidate x draw) pair in ONE ``simulate_batch_torch`` call on
    ``device``; only the volumes fed to it change per candidate.
    ``machine_models`` (machine -> HitModel) overrides the shared model on
    specific machines (heterogeneous budgets)."""
    draws = monte_carlo_draws(
        workload, seed=seed, n_iters=sim_iters, n_draws=sim_draws
    )
    rewriter = CacheRewriter(workload, cluster, model, machine_models=machine_models)

    def batch_cost(placements: Sequence[Placement]) -> List[float]:
        groups = [
            (p, [rewriter.adjust(p, r) for r in draws]) for p in placements
        ]
        return mean_batch_makespans(
            workload, cluster, groups, policy=policy, device=device
        )

    def scalar_cost(p: Placement) -> float:
        return batch_cost([p])[0]

    return scalar_cost, batch_cost, draws


def _coherent_config(config: Optional[CacheConfig], model: HitModel) -> CacheConfig:
    """Default the budget config off the hit model; reject an explicit
    config whose eviction policy disagrees with the model's — the search
    would reserve memory for one policy while simulating hit rates under
    another."""
    if config is None:
        return CacheConfig(policy=model.policy)
    if config.policy != model.policy:
        raise ValueError(
            f"CacheConfig.policy={config.policy!r} disagrees with the hit "
            f"model's policy={model.policy!r}; build the config with the "
            "model's policy (or omit it to inherit)"
        )
    return config


def cache_aware_etp(
    workload: Workload,
    cluster: ClusterSpec,
    model: HitModel,
    config: Optional[CacheConfig] = None,
    *,
    n_chains: int = 8,
    budget: int = 1000,
    sim_iters: int = 20,
    sim_draws: int = 1,
    seed: int = 0,
    policy: str = "oes",
    machine_models: Optional[Dict[int, HitModel]] = None,
    device: DeviceLike = None,
    **kw: Any,
) -> ETPResult:
    """Multi-chain ETP whose objective and capacity model are cache-aware.

    ``best_makespan`` is the winner's expected makespan under its OWN
    cache-adjusted traffic — comparable across placements (shared draws)
    but not to cache-oblivious search results (different objective).

    ``model.capacity_nodes`` (the residency the hit rates assume) and
    ``config.cache_gb`` (the memory the search reserves per machine) are
    two views of ONE cache size: derive one from the other with
    ``hitmodel.cache_gb_for_capacity`` / ``capacity_nodes_for_gb``.  A
    deliberately mismatched pair is allowed (what-if sweeps) but means the
    search pays for a different cache than the one it simulates.
    ``device`` is where every candidate is simulated (``None``: the CUDA
    card)."""
    config = _coherent_config(config, model)
    _, batch_cost, _ = cache_cost_fns(
        workload, cluster, model,
        sim_iters=sim_iters, sim_draws=sim_draws, seed=seed, policy=policy,
        machine_models=machine_models, device=device,
    )
    return etp_multichain(
        workload,
        cluster,
        n_chains=n_chains,
        budget=budget,
        seed=seed,
        sim_iters=sim_iters,
        sim_draws=sim_draws,
        policy=policy,
        batch_cost_fn=batch_cost,
        extra_violation=make_reservation_fn(workload, cluster, config),
        device=device,
        **kw,
    )


@dataclass
class CachePlan:
    """Outcome of cache-aware planning, with the audit trail benchmarks use."""

    placement: Placement
    etp: ETPResult
    schedule: ScheduleResult  # under cache-adjusted traffic
    uncached_makespan: float  # same placement, caches disabled
    adjusted: Realization
    config: CacheConfig


def cache_aware_plan(
    workload: Workload,
    cluster: ClusterSpec,
    model: HitModel,
    config: Optional[CacheConfig] = None,
    *,
    realization: Optional[Realization] = None,
    budget: int = 1000,
    n_chains: int = 8,
    sim_iters: int = 20,
    sim_draws: int = 1,
    seed: int = 0,
    policy: str = "oes",
    device: DeviceLike = None,
    **kw: Any,
) -> CachePlan:
    """End-to-end: cache-aware ETP search, then one recorded OES schedule of
    the chosen placement under its cache-adjusted realization, all on
    ``device``."""
    config = _coherent_config(config, model)
    realization = realization or workload.realize(seed=seed)
    etp = cache_aware_etp(
        workload, cluster, model, config,
        n_chains=n_chains, budget=budget, sim_iters=sim_iters,
        sim_draws=sim_draws, seed=seed, policy=policy, device=device, **kw,
    )
    adjusted = cache_adjusted_realization(
        workload, cluster, etp.placement, realization, model
    )
    # the recorded flow_log is the audit artifact
    schedule = simulate_torch(
        workload, cluster, etp.placement, adjusted, policy=policy, record=True,
        device=device,
    )
    uncached = simulate_torch(
        workload, cluster, etp.placement, realization, policy=policy,
        device=device,
    ).makespan
    return CachePlan(
        placement=etp.placement,
        etp=etp,
        schedule=schedule,
        uncached_makespan=uncached,
        adjusted=adjusted,
        config=config,
    )
