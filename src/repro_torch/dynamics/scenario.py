"""Drift scenarios: evaluate planning strategies against a ground-truth
time-varying cluster.

A copy of the JAX package's ``repro.dynamics.scenario`` on the torch
engine.  A scenario chops a training run into plan intervals (epoch
boundaries).  Per interval the chosen strategy may re-plan; any state
moves it commits are injected into the interval's TRUE dynamic
simulation as real ``MigrationFlow``s — ``simulate_torch(...,
trace=..., migrations=...)`` anchored at the wall-clock time the interval
starts, with one shared full-horizon realization sliced per interval so
every strategy sees identical traffic draws.  Migration is therefore
overlapped with training traffic and paid as whatever extra seconds the
engine observes.

Strategies:

  * ``static``  — one plan, never revisited;
  * ``replan``  — ``Replanner`` observes the bandwidth snapshot at each
    boundary, re-plans warm-started when drift exceeds the threshold, and
    its committed migration flows ride the interval;
  * ``oracle``  — upper bound: a from-scratch multi-chain search against
    every interval's snapshot with a larger budget and free migration.

Every simulation, the committed intervals' included, runs on
``ReplanConfig.device`` (``None``: the CUDA card).  The planner only
ever sees ``trace.bw_at(now)`` — the future of the trace stays hidden.
With a feature-cache tier (``hit_model``, ``cache_config``) each
interval's traffic is rewritten by its placement's hit rates, the caches
staying warm across intervals.
``collect_traces=True`` records each committed interval and keeps its
``repro_torch.obs.ScheduleTrace``; ``ScenarioOutcome.blame`` combines
their critical-path blame.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from ..core.cluster import ClusterSpec, Placement
from ..core.engine import MigrationFlow
from ..core.engine_torch import simulate_torch
from ..core.placement import etp_multichain, ifs_placement
from ..core.workload import Workload
from .replan import ReplannerConfig, Replanner
from .traces import BandwidthTrace

STRATEGIES = ("static", "replan", "oracle")


@dataclass
class IntervalOutcome:
    start_s: float  # wall-clock start of the interval
    makespan_s: float  # ACTUAL: includes overlapped migration traffic
    migration_s: float  # analytic per-NIC drain bound (reference only)
    overlap_s: float  # makespan_s minus the migration-free interval
    replanned: bool
    #: relative bandwidth drift of this interval's TRUE trace bandwidth
    #: against the strategy's planning reference: ``replan`` advances it
    #: on every commit, ``static`` and ``oracle`` never observe, so theirs
    #: reads as cumulative divergence from the t=0 snapshot
    drift: float
    #: the migration flows the interval's simulation carried (the port
    #: keeps them, so that a committed interval can be simulated again)
    flows: List[MigrationFlow] = field(default_factory=list)


@dataclass
class ScenarioOutcome:
    strategy: str
    shaping: Optional[str] = None  # traffic-class mode the flows rode under
    intervals: List[IntervalOutcome] = field(default_factory=list)
    placements: List[Placement] = field(default_factory=list)
    # one recorded ScheduleTrace per interval when the scenario ran with
    # collect_traces=True (repro_torch.obs) — empty otherwise
    traces: List[object] = field(default_factory=list)

    @property
    def compute_s(self) -> float:
        """Migration-free training time."""
        return float(sum(iv.makespan_s - iv.overlap_s for iv in self.intervals))

    @property
    def overlap_total_s(self) -> float:
        """What migration ACTUALLY cost, overlapped with training."""
        return float(sum(iv.overlap_s for iv in self.intervals))

    @property
    def migration_total_s(self) -> float:
        """Sum of the analytic drain bounds (the serial bills)."""
        return float(sum(iv.migration_s for iv in self.intervals))

    @property
    def total_s(self) -> float:
        """Wall-clock: migration rides inside each interval's makespan."""
        return float(sum(iv.makespan_s for iv in self.intervals))

    @property
    def serial_total_s(self) -> float:
        """Migration-free compute plus the analytic drain bills added
        serially; ``total_s <= serial_total_s`` is the overlap gain."""
        return self.compute_s + self.migration_total_s

    @property
    def n_replans(self) -> int:
        return sum(1 for iv in self.intervals if iv.replanned)

    def blame(self):
        """Combined critical-path blame over the run's intervals (requires
        ``run_scenario(..., collect_traces=True)``).  Per-interval blame
        conserves each interval's makespan, so the combined components sum
        to ``total_s`` — the decomposition that turns "replan beat static
        by X seconds" into named component deltas."""
        if not self.traces:
            raise ValueError(
                "no traces recorded — run_scenario(..., collect_traces=True)"
            )
        from ..obs.blame import blame as _blame, combine

        return combine([_blame(tr) for tr in self.traces])


def run_scenario(
    workload: Workload,
    cluster: ClusterSpec,
    trace: BandwidthTrace,
    *,
    strategy: str,
    n_intervals: int,
    iters_per_interval: int,
    seed: int = 0,
    init_placement: Optional[Placement] = None,
    replan_config: Optional[ReplannerConfig] = None,
    hit_model: Optional[object] = None,  # repro_torch.cache.HitModel
    cache_config: Optional[object] = None,  # repro_torch.cache.CacheConfig
    oracle_budget: int = 600,
    oracle_chains: int = 4,
    policy: str = "oes",
    collect_traces: bool = False,
) -> ScenarioOutcome:
    """Run ``n_intervals`` plan intervals of ``iters_per_interval``
    iterations each under ``strategy`` on the true dynamic cluster, on
    ``replan_config.device``.  ``hit_model`` / ``cache_config`` add the
    feature-cache tier: every interval's traffic is cache-adjusted for its
    placement, and ``replan`` searches against it.

    ``collect_traces=True`` records every interval's committed simulation
    and attaches one ``repro_torch.obs.ScheduleTrace`` per interval to
    ``ScenarioOutcome.traces`` (makespans are unchanged: recording is
    observational).  ``ScenarioOutcome.blame()`` then decomposes the
    run's total into named critical-path components."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; known: {STRATEGIES}")
    cfg = replan_config or ReplannerConfig()
    placement = init_placement or ifs_placement(workload, cluster, seed=seed)
    full = workload.realize(
        seed=seed, n_iters=n_intervals * iters_per_interval
    )
    replanner = Replanner(
        workload, cluster, placement.copy(), config=cfg,
        hit_model=hit_model, cache_config=cache_config,
    )
    # only the replan strategy commits migration flows, so only it can
    # ride them under a traffic-class shaping mode (cfg.shaping)
    shaping = cfg.shaping if strategy == "replan" else None
    out = ScenarioOutcome(strategy=strategy, shaping=shaping)
    now = 0.0
    model = hit_model
    for i in range(n_intervals):
        bw_in, bw_out = trace.bw_at(now)
        migration_s = 0.0
        flows = []
        drift = replanner.drift(bw_in, bw_out)
        replanned = False
        if strategy == "replan":
            rec = replanner.observe(
                bw_in, bw_out,
                served_iters=iters_per_interval if i > 0 else 0,
                remaining_intervals=n_intervals - i,
            )
            model = replanner.hit_model
            replanned = rec.replanned
            migration_s = rec.migration_s
            flows = rec.flows if rec.replanned else []
            placement = replanner.placement
        elif strategy == "oracle":
            if model is not None and i > 0:
                model = model.warm_started(iters_per_interval)
            snap = trace.snapshot_cluster(cluster, now)
            res = etp_multichain(
                workload, snap, n_chains=oracle_chains,
                budget=oracle_budget, seed=seed, policy=policy,
                sim_iters=cfg.sim_iters, sim_draws=cfg.sim_draws,
                device=cfg.device,
            )
            placement = res.placement
            replanned = True  # migration deliberately free: upper bound
        elif model is not None and i > 0:
            # static strategy: caches still warm across intervals
            model = model.warm_started(iters_per_interval)
        r_iv = full.window(i * iters_per_interval, (i + 1) * iters_per_interval)
        if model is not None:
            from ..cache.adjust import CacheRewriter

            r_iv = CacheRewriter(workload, cluster, model).adjust(placement, r_iv)
        tw = trace.window(now)
        # committed flows ride the TRUE interval simulation under the
        # replanner's shaping mode (their deadline annotations travel with
        # them); the clean reference never carries flows, so shaping would
        # be a no-op there and is skipped
        res_iv = simulate_torch(
            workload, cluster, placement, r_iv,
            policy=policy, trace=tw, migrations=flows or None,
            shaping=shaping if flows else None, device=cfg.device,
            record=collect_traces,
        )
        if collect_traces:
            from ..obs.trace import ScheduleTrace

            out.traces.append(
                ScheduleTrace.from_result(
                    res_iv, workload, cluster, placement, r_iv,
                    trace=tw, migrations=flows or None,
                    shaping=shaping if flows else None,
                )
            )
        overlap_s = 0.0
        if flows:
            clean_iv = simulate_torch(
                workload, cluster, placement, r_iv, policy=policy, trace=tw,
                device=cfg.device,
            )
            overlap_s = res_iv.makespan - clean_iv.makespan
        out.intervals.append(
            IntervalOutcome(
                start_s=now,
                makespan_s=res_iv.makespan,
                migration_s=migration_s,
                overlap_s=overlap_s,
                replanned=replanned,
                drift=drift,
                flows=list(flows),
            )
        )
        out.placements.append(placement.copy())
        now += res_iv.makespan
    return out
