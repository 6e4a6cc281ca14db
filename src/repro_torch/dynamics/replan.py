"""Incremental re-planning: warm-started ETP with migration as real flows.

A copy of the JAX package's ``repro.dynamics.replan`` on the torch
engine: every candidate-scoring simulation is ``simulate_batch_torch``
on ``ReplanConfig.device``.  The paper plans once and schedules online
forever after; under sustained bandwidth drift, stragglers and elastic
membership that single plan goes stale, and moving tasks costs real
time.  ``Replanner`` closes both gaps:

  * **warm start** — every re-plan seeds ETP from the incumbent placement
    (``etp_search(init=...)``), so the chain spends its budget refining
    rather than rediscovering;
  * **migration as scheduled flows** — each candidate's state moves are
    injected into the engine as ``MigrationFlow``s (released at t=0,
    gating the relocated tasks' first iteration) and the objective
    charges the simulated overlap delta: what the first interval pays
    with the moves competing against training traffic.  The closed-form
    per-NIC drain bill survives as ``migration_drain_bound``, a lower
    bound reported in every record but never the model;
  * **warm cache state** — when a feature-cache tier exists
    (``hit_model``), the objective prices each candidate's cache-adjusted
    traffic, with hit curves continuing from the previous interval's end
    (``HitModel.warm_started``) instead of pretending every re-plan
    starts cold, and ``cache_config`` reserves the cache's memory on each
    sampler-hosting machine;
  * **elastic membership** — machine leave (= failure) and join are the
    same re-plan path with the cluster edited first; forced restores off
    a dead machine are flows over the SURVIVING machines' NICs, in
    post-leave machine indices throughout, and per-machine cache budgets
    (``CacheConfig.cache_gb`` as a vector) shrink and grow with
    membership.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.cluster import ClusterSpec, Machine, Placement
from ..core.engine import (
    DeviceLike,
    MigrationFlow,
    ScheduleResult,
    monte_carlo_draws,
)
from ..core.engine_torch import simulate_batch_torch
from ..core.placement import ETPResult, etp_search, remap_after_leave
from ..core.units import GB, Ratio, Seconds
from ..core.workload import Workload
from ..obs import metrics as obs_metrics
from .traces import relative_bw_drift


RESTART_GB = 0.05  # process image / warm buffers any relocated task re-ships


def default_task_state_gb(workload: Workload, cluster: ClusterSpec) -> np.ndarray:
    """[J] GB that migrating each task moves over the network, by kind.

    * graph stores carry their PARTITION — the memory demand is the
      honest proxy (in practice restored from replicated storage, still
      over the same NICs);
    * workers / PSs carry model + optimizer state, sized from the job's
      own gradient volumes (3x a full gradient: params, moments, copy);
    * samplers are stateless beyond a small restart image — they re-read
      from the graph store, nothing bulk moves with them.

    Memory DEMAND is deliberately not the movable-state proxy for
    samplers/workers: working buffers are re-allocated, not shipped.
    Callers with real measurements pass their own vector."""
    state = np.full(workload.J, RESTART_GB)
    mem_r = (
        cluster.resource_types.index("mem")
        if "mem" in cluster.resource_types
        else None
    )
    demands = cluster.demand_matrix(workload.tasks)
    grad_out = np.zeros(workload.J)  # worker -> sum of its gradient volumes
    grad_in = np.zeros(workload.J)  # ps -> sum of shard volumes it serves
    for e, edge in enumerate(workload.edges):
        v = float(workload.traffic.mean_volume[e])
        if edge.kind in ("w2p", "ring"):
            grad_out[edge.src] += v
        if edge.kind == "w2p":
            grad_in[edge.dst] += v
    for j, t in enumerate(workload.tasks):
        if t.kind == "store":
            if mem_r is not None:
                state[j] += demands[j, mem_r]
        elif t.kind == "worker":
            state[j] += 3.0 * grad_out[j]
        elif t.kind == "ps":
            state[j] += 3.0 * grad_in[j]
    return state


def build_migration_flows(
    old_y: np.ndarray,
    new_y: np.ndarray,
    state_gb: np.ndarray,
) -> List[MigrationFlow]:
    """The discretionary moves ``old -> new`` as engine flows: one
    ``MigrationFlow`` per relocated task, gating that task's first
    post-replan iteration on its state's arrival."""
    old_y = np.asarray(old_y)
    new_y = np.asarray(new_y)
    moved = (new_y != old_y) & (old_y >= 0)
    return [
        MigrationFlow(
            src=int(old_y[j]), dst=int(new_y[j]),
            gb=float(state_gb[j]), task=int(j),
        )
        for j in np.nonzero(moved)[0]
    ]


def annotate_deadlines(
    flows: Sequence[MigrationFlow],
    clean_results: Sequence[ScheduleResult],
) -> List[MigrationFlow]:
    """Fill each gated flow's ``deadline`` with the gated task's slack: the
    earliest start of its FIRST iteration across the recorded clean-variant
    simulations — the task's earliest possible start absent migration.  A
    flow that lands by then provably delays nothing, so deadline shaping
    keeps it in the background exactly as long as that slack allows and
    escalates it EDF-style once the slack is consumed.  Ungated flows pass
    through untouched (``inf`` deadline: never escalates)."""
    starts: Dict[int, float] = {}
    for res in clean_results:
        for ev in res.task_events:
            if ev.iter == 1:
                cur = starts.get(ev.task)
                if cur is None or ev.start < cur:
                    starts[ev.task] = ev.start
    return [
        dataclasses.replace(f, deadline=float(starts.get(f.task, float("inf"))))
        if f.task >= 0
        else f
        for f in flows
    ]


def migration_drain_bound(
    cluster: ClusterSpec, flows: Sequence[MigrationFlow]
) -> Seconds:
    """Per-NIC drain LOWER bound on completing ``flows``: every NIC must
    carry its total migration bytes at a rate no higher than its capacity,
    so the slowest NIC's drain time bounds ANY schedule — overlapped or
    not — from below (with equality on an idle cluster with NIC-disjoint
    flows).  Migration is priced by simulating it as engine flows; this
    bound is reported beside that price, never used as it."""
    out_gb = np.zeros(cluster.M)
    in_gb = np.zeros(cluster.M)
    for f in flows:
        if not (0 <= f.src < cluster.M and 0 <= f.dst < cluster.M):
            raise ValueError(
                f"migration flow {f} references a machine outside the "
                f"{cluster.M}-machine cluster — remap after membership "
                "changes before billing (stale pre-leave indices?)"
            )
        if f.src == f.dst or f.gb <= 0:
            continue
        out_gb[f.src] += f.gb
        in_gb[f.dst] += f.gb
    if not out_gb.any() and not in_gb.any():
        return 0.0
    out_s = out_gb / np.maximum(cluster.bw_out, 1e-9)
    in_s = in_gb / np.maximum(cluster.bw_in, 1e-9)
    return float(max(out_s.max(), in_s.max()))


def migration_time(
    cluster: ClusterSpec,
    old_y: np.ndarray,
    new_y: np.ndarray,
    state_gb: np.ndarray,
) -> Seconds:
    """Seconds to drain every relocated task's state over current NICs if
    transfers serialised per NIC and ran in parallel across NICs — the
    certified LOWER bound on the flow-scheduled completion (see
    ``migration_drain_bound``), kept as the analytic reference.

    Raises when a placement indexes a machine the cluster does not have:
    after a leave, PRE-leave indices silently bincounted against the
    POST-leave ``bw_in`` / ``bw_out`` arrays either mis-shape or — worse —
    charge the wrong machine's NIC."""
    old_y = np.asarray(old_y)
    new_y = np.asarray(new_y)
    for name, y in (("old_y", old_y), ("new_y", new_y)):
        bad = y[(y >= cluster.M) | ((y < 0) & (y != -1))]
        if bad.size:
            raise ValueError(
                f"{name} indexes machine {int(bad[0])} but the cluster has "
                f"{cluster.M} machines — remap placements after membership "
                "changes before billing (stale pre-leave indices?)"
            )
    return migration_drain_bound(
        cluster, build_migration_flows(old_y, new_y, state_gb)
    )


@dataclass
class ReplannerConfig:
    """Knobs of the incremental re-planner: the reference's
    ``ReplanConfig``, with ``device`` in place of ``backend`` (the name
    ``ReplanConfig`` is an alias of this class).

    ``shaping`` selects the traffic-class treatment of migration flows in
    BOTH the candidate-scoring simulations and the committed schedule:
    ``None`` (migration competes as an equal), ``"strict"`` (migration
    only gets leftover NIC capacity) or ``"deadline"`` (strict until a
    gated flow's slack — the gated task's earliest possible start in the
    clean variant — is consumed, then the flow escalates strictly above
    the training class, EDF-style).  Deadlines are filled automatically
    from the clean-variant simulation the objective already runs.

    ``device`` is where every candidate-scoring batch runs (``None``: the
    CUDA card; it raises without one)."""

    drift_threshold: float = 0.25  # max relative NIC change tolerated
    budget: int = 250  # warm ETP transitions per re-plan
    sim_iters: int = 12
    sim_draws: int = 1
    policy: str = "oes"
    migration_weight: float = 1.0  # 0 disables the migration term
    shaping: Optional[str] = None  # None | "strict" | "deadline"
    seed: int = 0
    device: DeviceLike = None  # where candidate scoring runs


ReplanConfig = ReplannerConfig


@dataclass
class ReplanRecord:
    """Audit row for one re-plan decision (taken or declined).

    ``makespan`` and ``objective`` are deliberately separate: ``makespan``
    is the raw simulated steady-state cost of the committed placement
    (no migration anywhere in it), ``objective`` is what the search
    minimised (``makespan + amortised overlap``)."""

    trigger: str  # "epoch" | "drift" | "leave" | "join" | "forced"
    replanned: bool
    drift: Ratio
    moved_tasks: int = 0
    migration_gb: GB = 0.0  # discretionary state moved (beyond warm start)
    forced_gb: GB = 0.0  # state force-restored after a machine leave
    migration_s: Seconds = 0.0  # analytic per-NIC drain LOWER bound, unamortised
    overlap_s: Seconds = 0.0  # simulated first-interval delta vs migration-free
    makespan: Seconds = float("nan")  # raw simulated makespan, no migration
    objective: Seconds = float("nan")  # makespan + amortised overlap (searched)
    flows: List[MigrationFlow] = field(default_factory=list)
    etp: Optional[ETPResult] = None


@dataclass
class Replanner:
    """Carries the incumbent (placement, cluster) across plan intervals
    and re-plans incrementally on epoch boundaries, detected drift, or
    membership changes.

    ``repro_torch.dynamics.scenario`` drives the epoch / drift path
    against ground-truth bandwidth traces and injects each committed
    record's ``flows`` into the true interval simulation."""

    workload: Workload
    cluster: ClusterSpec
    placement: Placement
    config: ReplannerConfig = field(default_factory=ReplannerConfig)
    state_gb: Optional[np.ndarray] = None
    hit_model: Optional[object] = None  # repro_torch.cache.HitModel
    cache_config: Optional[object] = None  # repro_torch.cache.CacheConfig
    records: List[ReplanRecord] = field(default_factory=list)
    #: optional override for candidate-scoring realizations, called as
    #: ``draws_fn(seed, n_iters, n_draws) -> List[Realization]`` (merged
    #: multi-job workloads need it: they cannot ``realize`` themselves)
    draws_fn: Optional[Callable[[int, int, int], List]] = None

    def __post_init__(self) -> None:
        if self.state_gb is None:
            self.state_gb = default_task_state_gb(self.workload, self.cluster)
        self.state_gb = np.asarray(self.state_gb, dtype=np.float64)
        self._planned_bw_in = self.cluster.bw_in.copy()
        self._planned_bw_out = self.cluster.bw_out.copy()

    # -- drift ------------------------------------------------------------
    def drift(self, bw_in: np.ndarray, bw_out: np.ndarray) -> Ratio:
        return relative_bw_drift(
            self._planned_bw_in, self._planned_bw_out, bw_in, bw_out
        )

    def should_replan(self, bw_in: np.ndarray, bw_out: np.ndarray) -> bool:
        return self.drift(bw_in, bw_out) > self.config.drift_threshold

    # -- cache state ------------------------------------------------------
    def advance_cache(self, served_iters: int) -> None:
        """The previous interval served ``served_iters`` iterations: the
        deployed caches kept their contents, so the NEXT plan's hit curves
        continue from there."""
        if self.hit_model is not None and served_iters > 0:
            self.hit_model = self.hit_model.warm_started(served_iters)

    def _cost_fn(
        self, cluster: ClusterSpec
    ) -> Tuple[Optional[Callable[..., Any]], Optional[Callable[..., Any]]]:
        """(cost_fn, extra_violation) for ETP on ``cluster``: cache-aware
        (warm model + per-machine reservations) when a cache tier exists,
        engine defaults otherwise."""
        if self.hit_model is None:
            return None, None
        from ..cache.planner import cache_cost_fns, make_reservation_fn

        scalar_cost, _, _ = cache_cost_fns(
            self.workload, cluster, self.hit_model,
            sim_iters=self.config.sim_iters, sim_draws=self.config.sim_draws,
            seed=self.config.seed, policy=self.config.policy,
            device=self.config.device,
        )
        extra = (
            make_reservation_fn(self.workload, cluster, self.cache_config)
            if self.cache_config is not None
            else None
        )
        return scalar_cost, extra

    # -- the re-plan core -------------------------------------------------
    def replan(
        self,
        cluster_now: Optional[ClusterSpec] = None,
        *,
        trigger: str = "forced",
        migration_free: bool = False,
        budget: Optional[int] = None,
        amortize_over: int = 1,
        forced_restores: Optional[Dict[int, int]] = None,
    ) -> ReplanRecord:
        """Warm-started ETP from the incumbent on ``cluster_now`` (defaults
        to the stored cluster, i.e. membership unchanged).  Each candidate's
        state moves become engine ``MigrationFlow``s and its objective is

            clean_makespan + (weight/amortize_over) * overlap_delta

        where ``overlap_delta = loaded - clean`` from simulating the first
        interval WITH the flows injected.  Under ``cfg.shaping`` the
        loaded variant runs with migration traffic shaped by class, so
        candidates are scored under exactly the schedule the committed
        flows will ride.

        ``amortize_over``: the number of plan intervals the new placement
        is expected to persist for; the overlap is paid once, so the
        objective charges ``overlap / amortize_over``.

        ``forced_restores`` (the leave path) maps an orphaned task to the
        machine its state streams FROM (its replica holder): every
        candidate gets one restore flow ``replica -> candidate host`` per
        orphan, tracking the candidate.  Commits the winner."""
        cfg = self.config
        cluster_now = cluster_now or self.cluster
        incumbent = self.placement.copy()
        old_y = incumbent.y.copy()
        weight = (
            0.0
            if migration_free
            else cfg.migration_weight / max(int(amortize_over), 1)
        )
        forced = dict(forced_restores or {})
        # orphans are excluded from the discretionary old->new diff: their
        # state originates at the replica holder, not the warm host
        old_y_disc = old_y.copy()
        for j in forced:
            old_y_disc[j] = -1
        if self.draws_fn is not None:
            reals = self.draws_fn(cfg.seed, cfg.sim_iters, cfg.sim_draws)
        else:
            reals = monte_carlo_draws(
                self.workload, seed=cfg.seed, n_iters=cfg.sim_iters,
                n_draws=cfg.sim_draws,
            )
        n_d = len(reals)
        cache_cost, extra = self._cost_fn(cluster_now)
        rewriter = None
        if self.hit_model is not None:
            from ..cache.adjust import CacheRewriter

            rewriter = CacheRewriter(self.workload, cluster_now, self.hit_model)
        # per-placement (base, overlap, flows) for the committed record,
        # filled by the objective as the chain measures candidates (memoised
        # upstream by placement key, so each unique candidate is simulated
        # once); flows carry deadline annotations under deadline shaping
        side: Dict[bytes, Tuple[float, float, List[MigrationFlow]]] = {}

        def sim_pair(
            p: Placement, migs: List[MigrationFlow]
        ) -> Tuple[float, float, List[MigrationFlow]]:
            """(clean, loaded, flows) mean makespans; the loaded variant
            injects ``migs`` under ``cfg.shaping`` — with strict or no
            shaping both variants run in ONE lock-step batch.  Deadline
            shaping needs the clean variant first: it is recorded, the
            gated flows' deadlines are filled from its task starts
            (``annotate_deadlines``), and the loaded variant runs second;
            the returned ``flows`` carry those deadlines.  With a cache
            tier the draws are rewritten to ``p``'s cache-adjusted traffic
            first, so the overlap is priced against the contention the
            flows will see in the scenario's interval simulation."""
            rs = [rewriter.adjust(p, r) for r in reals] if rewriter else list(reals)
            if migs and cfg.shaping == "deadline":
                clean_res = simulate_batch_torch(
                    self.workload, cluster_now, [p] * n_d, rs,
                    policy=cfg.policy, record=True, device=cfg.device,
                )
                clean = sum(r.makespan for r in clean_res) / n_d
                migs = annotate_deadlines(migs, clean_res)
                loaded_res = simulate_batch_torch(
                    self.workload, cluster_now, [p] * n_d, rs,
                    policy=cfg.policy, shaping="deadline",
                    migrations=[migs] * n_d, device=cfg.device,
                )
                loaded = sum(r.makespan for r in loaded_res) / n_d
            elif migs:
                res = simulate_batch_torch(
                    self.workload, cluster_now, [p] * (2 * n_d), rs + rs,
                    policy=cfg.policy, shaping=cfg.shaping,
                    migrations=[None] * n_d + [migs] * n_d,
                    device=cfg.device,
                )
                clean = sum(r.makespan for r in res[:n_d]) / n_d
                loaded = sum(r.makespan for r in res[n_d:]) / n_d
            else:
                res = simulate_batch_torch(
                    self.workload, cluster_now, [p] * n_d, rs,
                    policy=cfg.policy, device=cfg.device,
                )
                clean = sum(r.makespan for r in res) / n_d
                loaded = clean
            return clean, loaded, migs

        def flows_for(p: Placement) -> List[MigrationFlow]:
            restores = [
                MigrationFlow(
                    src=src, dst=int(p.y[j]),
                    gb=float(self.state_gb[j]), task=int(j),
                )
                for j, src in sorted(forced.items())
            ]
            return restores + build_migration_flows(
                old_y_disc, p.y, self.state_gb
            )

        def objective(p: Placement) -> float:
            migs = flows_for(p)
            if cache_cost is not None:
                base = cache_cost(p)
                overlap = 0.0
                if migs and weight > 0:
                    clean, loaded, migs = sim_pair(p, migs)
                    overlap = loaded - clean
            elif migs and weight > 0:
                base, loaded, migs = sim_pair(p, migs)
                overlap = loaded - base
            else:
                base, _, _ = sim_pair(p, [])
                overlap = 0.0
            side[p.key()] = (base, overlap, migs)
            # gating can perturb event phasing enough that the loaded run
            # occasionally finishes EARLIER (a scheduling anomaly, not a
            # migration rebate) — price only non-negative overlap; the
            # record still reports the signed physical delta
            return base + weight * max(0.0, overlap)

        res = etp_search(
            self.workload,
            cluster_now,
            budget=budget if budget is not None else cfg.budget,
            seed=cfg.seed,
            init=incumbent,
            policy=cfg.policy,
            sim_iters=cfg.sim_iters,
            sim_draws=cfg.sim_draws,
            cost_fn=objective,
            extra_violation=extra,
            device=cfg.device,
        )
        committed = res.placement
        base, overlap, flows = side[committed.key()]
        if flows and weight == 0.0:
            # the objective never priced migration (migration_free): still
            # report the physical overlap of whatever moves it chose
            clean, loaded, flows = sim_pair(committed, flows)
            overlap = loaded - clean
        moved = (committed.y != old_y_disc) & (old_y_disc >= 0)
        same_m = len(cluster_now.bw_in) == len(self._planned_bw_in)
        rec = ReplanRecord(
            trigger=trigger,
            replanned=True,
            # drift is undefined across a membership change (the machine
            # sets differ); the trigger already names the cause there
            drift=self.drift(cluster_now.bw_in, cluster_now.bw_out)
            if same_m
            else float("nan"),
            moved_tasks=int(moved.sum()),
            migration_gb=float(self.state_gb[moved].sum()),
            forced_gb=float(sum(self.state_gb[j] for j in forced)),
            migration_s=migration_drain_bound(cluster_now, flows),
            overlap_s=float(overlap),
            makespan=float(base),
            objective=float(res.best_makespan),
            flows=flows,
            etp=res,
        )
        self.cluster = cluster_now
        self.placement = committed
        self._planned_bw_in = cluster_now.bw_in.copy()
        self._planned_bw_out = cluster_now.bw_out.copy()
        self.records.append(rec)
        if obs_metrics.REGISTRY.enabled:
            reg = obs_metrics.REGISTRY
            reg.counter("replan.replans").inc()
            reg.counter(f"replan.trigger.{trigger}").inc()
            reg.counter("replan.moved_tasks").inc(rec.moved_tasks)
            reg.counter("replan.migration_gb").inc(rec.migration_gb)
            reg.histogram("replan.overlap_s").observe(rec.overlap_s)
            if np.isfinite(rec.drift):
                reg.histogram("replan.drift").observe(rec.drift)
        return rec

    def observe(
        self,
        bw_in: np.ndarray,
        bw_out: np.ndarray,
        *,
        trigger: str = "epoch",
        served_iters: int = 0,
        remaining_intervals: int = 1,
    ) -> ReplanRecord:
        """Epoch-boundary hook: advance warm cache state, threshold the
        observed bandwidth drift, re-plan against the current snapshot if
        it exceeds the tolerance — otherwise keep the incumbent (recorded
        as a declined decision).  ``remaining_intervals`` amortises the
        migration overlap over the plan's expected lifetime (see
        ``replan``)."""
        self.advance_cache(served_iters)
        d = self.drift(bw_in, bw_out)
        if d > self.config.drift_threshold:
            return self.replan(
                self.cluster.with_bandwidth(bw_in, bw_out),
                trigger="drift",
                amortize_over=remaining_intervals,
            )
        rec = ReplanRecord(trigger=trigger, replanned=False, drift=d)
        self.records.append(rec)
        if obs_metrics.REGISTRY.enabled:
            obs_metrics.REGISTRY.counter("replan.declined").inc()
            obs_metrics.REGISTRY.histogram("replan.drift").observe(d)
        return rec

    # -- elastic membership ----------------------------------------------
    def on_leave(self, machine: int) -> ReplanRecord:
        """Machine leave/failure: remap the orphaned tasks onto the
        survivors (``remap_after_leave``), shrink per-machine cache
        budgets, then run the standard warm re-plan.

        The forced moves off the dead machine are already inside the warm
        start, so the discretionary migration term only charges moves
        beyond them; their state is restored as real flows over the
        SURVIVING machines' NICs: each orphan's state streams from its
        replica holder (the next surviving machine in the pre-leave ring)
        to its new host, in post-leave machine indices throughout."""
        old_y = self.placement.y.copy()  # pre-leave indices
        m_old = self.cluster.M
        new_cluster, warm = remap_after_leave(
            self.workload, self.cluster, self.placement, machine
        )
        replica_pre = (machine + 1) % m_old
        replica = replica_pre - 1 if replica_pre > machine else replica_pre
        forced = {
            int(j): replica for j in np.nonzero(old_y == machine)[0]
        }
        self.placement = warm
        self._drop_cache_budget(machine)
        return self.replan(
            new_cluster, trigger="leave", forced_restores=forced
        )

    def on_join(self, machine: Machine, *, cache_gb: float = 0.0) -> ReplanRecord:
        """Machine join: the incumbent stays valid (indices unchanged),
        the new machine arrives empty with its own cache budget
        (heterogeneous by construction), and the warm re-plan decides what
        is worth moving onto it given the simulated migration overlap."""
        new_cluster = self.cluster.with_machine(machine)
        self._grow_cache_budget(new_cluster.M, cache_gb)
        return self.replan(new_cluster, trigger="join")

    def _drop_cache_budget(self, machine: int) -> None:
        if self.cache_config is None:
            return
        gb = np.asarray(self.cache_config.cache_gb, dtype=np.float64)
        if gb.ndim == 0:
            return  # scalar broadcasts to any M
        self.cache_config = dataclasses.replace(
            self.cache_config, cache_gb=np.delete(gb, machine)
        )

    def _grow_cache_budget(self, new_m: int, cache_gb: float) -> None:
        if self.cache_config is None:
            return
        gb = self.cache_config.cache_gb_per_machine(new_m - 1)
        self.cache_config = dataclasses.replace(
            self.cache_config, cache_gb=np.append(gb, float(cache_gb))
        )
