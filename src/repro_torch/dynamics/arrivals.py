"""Scheduler-as-a-service: arrival-driven multi-tenant streams.

A copy of the JAX package's ``repro.dynamics.arrivals`` on the torch
engine.  The reference pins its committed epochs, admission checks and
solo runs to the numpy engine and scores re-plan candidates on its
``backend``; the port has one engine, so every one of these simulations
runs on ``ServiceConfig.device`` (``None``: the CUDA card).
``collect_traces=True`` keeps each committed epoch's schedule trace, and
``ServiceOutcome.tenant_blame`` splits the critical path by tenant.

The paper's conclusion points DGTP at multiple GNN jobs sharing one
cluster; production traffic is a *stream* — jobs arrive with deadlines
and QoS classes, are admitted (or not), train co-scheduled on shared
NICs, and leave.  This driver closes that loop on top of the existing
primitives:

  * ``core.multijob.IncrementalMerge`` — the active set is one merged
    workload; membership changes re-merge incrementally (stable per-job
    seed tokens keep every survivor's traffic draws fixed while
    neighbours churn);
  * admission control — a candidate job is admitted only if a predictive
    merged simulation against the CURRENT residual load says it meets
    its deadline without pushing any already-admitted tenant past its
    own (otherwise it is deferred to the next membership change, and
    rejected after ``max_defer`` tries or when even a solo run could no
    longer make the deadline);
  * per-job QoS — each tenant's edges ride its arrival's class through
    ``merged_edge_classes`` and the engine's class shaping (``deadline``
    shaping escalates a starved tenant EDF-style); discretionary re-plan
    migrations ride strictly BELOW every tenant class;
  * warm re-planning — each epoch re-plans through ``Replanner`` seeded
    from the carried-over placement, with ``draws_fn`` routed through the
    incremental merge (merged workloads refuse ``Workload.realize``).

Epoch semantics (the isolation invariant): the stream is simulated in
EPOCHS cut ONLY at admissions and completions — membership changes.  A
rejected or deferred arrival is evaluated purely predictively against
the committed epoch schedule and never cuts it, so a rejected job
NEVER perturbs admitted tenants' schedules: running the same stream
with the rejected arrival removed yields byte-identical schedules on
one device (pinned by tests/test_torch_arrivals.py).
Iterations in flight when an epoch is cut are conservatively re-run in
the next epoch (served counts floor to completed iterations).

Baselines: ``run_ordering_baseline`` runs the same stream EXCLUSIVELY
(one job at a time) under EDF / SJF / round-robin ordering — the
orderings a shared cluster without co-scheduling would use.  Jobs whose
compute dominates overlap almost perfectly when merged, so the service
completes them in ~max(solo) wall-clock where exclusive orders pay
~sum(solo); on a mixed-QoS stream the service meets strictly more
deadlines than each ordering (tests/test_torch_arrivals.py).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.cluster import ClusterSpec, Placement, is_feasible
from ..core.engine import DeviceLike, MigrationFlow
from ..core.engine_torch import simulate_torch
from ..core.multijob import (
    IncrementalMerge,
    MergedJob,
    derive_seed,
    merge_workloads,
    merged_edge_classes,
    per_job_iteration_ends,
    per_job_makespans,
    realize_merged,
)
from ..core.placement import ifs_placement
from ..core.units import GB, Ratio, Seconds
from ..core.workload import Workload
from ..obs import metrics as obs_metrics
from .replan import ReplanConfig, Replanner

#: seed namespaces for the service's derivation levels (disjoint from
#: core.multijob's SEED_NS_JOB / SEED_NS_DRAW)
SEED_NS_EPOCH = 0x65706F63  # committed epoch realizations
SEED_NS_ADMIT = 0x61646D69  # predictive admission draws
SEED_NS_SOLO = 0x736F6C6F  # solo reference runs (slowdown denominators)

_EPS = 1e-9

ORDERINGS = ("edf", "sjf", "rr")


@dataclass(frozen=True)
class JobArrival:
    """One tenant's job entering the stream.

    ``deadline_s`` is ABSOLUTE wall-clock (same axis as ``t_arrive``);
    ``qos`` is the tenant's traffic class (lower = higher priority, any
    non-negative int — ``merged_edge_classes`` semantics)."""

    name: str
    t_arrive: Seconds
    workload: Workload
    deadline_s: Seconds
    qos: int = 0


@dataclass
class TenantOutcome:
    """Per-tenant SLO row."""

    name: str
    t_arrive: Seconds
    deadline_s: Seconds
    qos: int
    admitted: bool = False
    n_defers: int = 0
    t_admit: Seconds = math.nan
    t_complete: Seconds = math.inf  # inf when rejected
    solo_makespan_s: Seconds = math.nan  # uncontended reference run

    @property
    def met(self) -> bool:
        return self.admitted and self.t_complete <= self.deadline_s + _EPS

    @property
    def slowdown(self) -> Ratio:
        """(completion - arrival) / solo makespan; inf when rejected."""
        if not self.admitted or not math.isfinite(self.t_complete):
            return math.inf
        return (self.t_complete - self.t_arrive) / self.solo_makespan_s


def jain_index(xs: Sequence[float]) -> float:
    """Jain's fairness index in (0, 1]; 1.0 = perfectly even."""
    xs = [x for x in xs if math.isfinite(x)]
    if not xs:
        return 1.0
    s, s2 = sum(xs), sum(x * x for x in xs)
    return float(s * s / (len(xs) * s2)) if s2 > 0 else 1.0


@dataclass
class SLOReport:
    tenants: List[TenantOutcome]

    @property
    def n_jobs(self) -> int:
        return len(self.tenants)

    @property
    def n_admitted(self) -> int:
        return sum(1 for t in self.tenants if t.admitted)

    @property
    def deadlines_met(self) -> int:
        return sum(1 for t in self.tenants if t.met)

    @property
    def mean_slowdown(self) -> float:
        xs = [t.slowdown for t in self.tenants if t.admitted]
        return float(np.mean(xs)) if xs else math.nan

    @property
    def fairness(self) -> float:
        """Jain index over admitted tenants' speedups (1/slowdown): 1.0
        means contention was shared perfectly evenly."""
        return jain_index(
            [1.0 / t.slowdown for t in self.tenants if t.admitted]
        )

    def table(self, label: str = "slo") -> str:
        rows = [
            f"{label}: {self.deadlines_met}/{self.n_jobs} deadlines met, "
            f"{self.n_admitted} admitted, fairness {self.fairness:.3f}"
        ]
        for t in self.tenants:
            status = (
                "REJECTED"
                if not t.admitted
                else ("met     " if t.met else "MISSED  ")
            )
            comp = "-" if not math.isfinite(t.t_complete) else f"{t.t_complete:8.2f}"
            slow = "-" if not t.admitted else f"{t.slowdown:5.2f}x"
            rows.append(
                f"  {t.name:<10s} qos={t.qos} arrive={t.t_arrive:7.2f} "
                f"deadline={t.deadline_s:8.2f} complete={comp:>8s} "
                f"{status} slowdown={slow:>7s} defers={t.n_defers}"
            )
        return "\n".join(rows)


@dataclass
class ServiceEvent:
    """Audit row: one admission decision or completion."""

    t: Seconds
    kind: str  # "admit" | "reject" | "defer" | "complete"
    job: str
    detail: str = ""


@dataclass
class EpochRecord:
    """One committed co-scheduled interval between membership changes."""

    start_s: Seconds
    end_s: Seconds
    reason: str  # "arrival" | "completion" | "drain"
    jobs: List[str]
    served: Dict[str, int]  # iterations committed this epoch
    replanned: bool = False
    migration_gb: GB = 0.0


@dataclass
class ServiceOutcome:
    report: SLOReport
    epochs: List[EpochRecord] = field(default_factory=list)
    events: List[ServiceEvent] = field(default_factory=list)
    #: per epoch, when collect_traces=True: (ScheduleTrace, task_offsets,
    #: job names) — the inputs ``obs.blame_by_tenant`` needs
    traces: List[Tuple[object, List[int], List[str]]] = field(
        default_factory=list
    )

    def tenant_blame(self) -> Dict[str, float]:
        """Critical-path seconds attributed to each tenant, summed over
        epochs (requires ``collect_traces=True``).  Per epoch the shares
        conserve the epoch makespan at machine precision (``obs.blame``
        telescoping), so the totals conserve the summed schedule length;
        the service's own migration overhead lands under ``"<service>"``."""
        if not self.traces:
            raise ValueError(
                "no traces recorded — run_service(..., collect_traces=True)"
            )
        from ..obs.blame import SERVICE_TENANT, blame_by_tenant

        out: Dict[str, float] = {}
        for tr, offsets, names in self.traces:
            for ji, share in blame_by_tenant(tr, offsets).items():
                key = "<service>" if ji == SERVICE_TENANT else names[ji]
                out[key] = out.get(key, 0.0) + share
        return out


@dataclass
class ServiceConfig:
    """Knobs of the arrival-driven service driver.

    ``admit_margin`` demands predicted completions beat deadlines by the
    given fraction (0.1 = 10% slack) — admission optimism insurance.
    ``shaping`` is the traffic-class mode every committed epoch runs
    under (per-tenant classes from the arrivals' ``qos``; ``deadline``
    additionally escalates tenants that have burned their slack).
    ``replan=True`` re-plans warm through ``Replanner`` at every epoch
    (membership change); the replan's discretionary migration flows ride
    the epoch BELOW every tenant class.  ``device`` is where every
    simulation runs: committed epochs, admission checks, solo runs and
    the default re-plan's candidate scoring (a ``replan_config`` given
    here keeps its own ``device``)."""

    policy: str = "oes"
    shaping: Optional[str] = "strict"  # None | "strict" | "deadline"
    seed: int = 0
    admit_margin: float = 0.0
    max_defer: int = 2
    replan: bool = True
    replan_config: Optional[ReplanConfig] = None
    device: DeviceLike = None  # where every simulation runs
    #: when True, a background-class tenant (qos > 0) whose committed
    #: epoch schedule would sail past its deadline is ESCALATED to class 0
    #: for the epoch and the epoch re-simulated ONCE — the service-level
    #: analogue of deadline shaping's per-flow EDF escalation.  Purely a
    #: deterministic function of the committed epoch, so it preserves the
    #: rejected-arrival isolation invariant.
    escalate: bool = True


# ---------------------------------------------------------------------------
# Solo references
# ---------------------------------------------------------------------------
def solo_makespan(
    job: Workload, cluster: ClusterSpec, *, seed: int = 0, index: int = 0,
    policy: str = "oes", device: DeviceLike = None,
) -> Seconds:
    """Uncontended reference: the job alone on the full cluster (IFS
    placement, one draw).  Slowdown denominator, SJF key, and the
    admission controller's hopeless-reject bound."""
    p = ifs_placement(job, cluster, seed=seed)
    r = job.realize(seed=derive_seed(seed, SEED_NS_SOLO, index))
    return simulate_torch(job, cluster, p, r, policy=policy, device=device).makespan


# ---------------------------------------------------------------------------
# The service driver
# ---------------------------------------------------------------------------
@dataclass
class _Active:
    """Driver-side state of one admitted tenant."""

    arrival: JobArrival
    outcome: TenantOutcome
    residual: int  # iterations still owed


class _Epoch:
    """One committed co-scheduled schedule between membership changes."""

    def __init__(
        self,
        mj: MergedJob,
        placement: Placement,
        start_s: float,
        iter_ends: List[np.ndarray],
        replanned: bool,
        migration_gb: float,
        trace_row: Optional[Tuple[object, List[int], List[str]]],
    ) -> None:
        self.mj = mj
        self.placement = placement
        self.start_s = start_s
        self.iter_ends = iter_ends
        self.replanned = replanned
        self.migration_gb = migration_gb
        self.trace_row = trace_row

    def completion_abs(self, ji: int) -> float:
        return self.start_s + float(self.iter_ends[ji][-1])

    def served_by(self, ji: int, t_abs: float) -> int:
        """Iterations of job ``ji`` fully completed by ``t_abs``."""
        rel = t_abs - self.start_s
        return int(np.searchsorted(self.iter_ends[ji], rel + _EPS))


def run_service(
    stream: Sequence[JobArrival],
    cluster: ClusterSpec,
    config: Optional[ServiceConfig] = None,
    *,
    collect_traces: bool = False,
) -> ServiceOutcome:
    """Run an arrival stream through the multi-tenant service.

    See the module docstring for the epoch/admission semantics.  Returns
    per-tenant SLO accounting and the epoch log.  ``collect_traces=True``
    keeps one ``(ScheduleTrace, task_offsets, names)`` row per committed
    epoch on ``ServiceOutcome.traces`` (``tenant_blame`` reads them)."""
    cfg = config or ServiceConfig()
    arrivals = sorted(stream, key=lambda a: (a.t_arrive, a.name))
    names = [a.name for a in arrivals]
    if len(set(names)) != len(names):
        raise ValueError("arrival names must be unique")

    outcomes: Dict[str, TenantOutcome] = {}
    solo: Dict[str, float] = {}
    for i, a in enumerate(arrivals):
        outcomes[a.name] = TenantOutcome(
            name=a.name, t_arrive=a.t_arrive, deadline_s=a.deadline_s,
            qos=a.qos,
        )
        solo[a.name] = solo_makespan(
            a.workload, cluster, seed=cfg.seed, index=i, policy=cfg.policy,
            device=cfg.device,
        )
        outcomes[a.name].solo_makespan_s = solo[a.name]

    out = ServiceOutcome(report=SLOReport(tenants=[outcomes[n] for n in names]))
    inc = IncrementalMerge()
    active: Dict[str, _Active] = {}
    deferred: List[Tuple[int, JobArrival]] = []  # (n_defers, arrival)
    pending = list(arrivals)
    epoch: Optional[_Epoch] = None
    epoch_idx = 0
    now = 0.0
    reg = obs_metrics.REGISTRY

    def record_event(kind: str, job: str, detail: str = "") -> None:
        out.events.append(ServiceEvent(t=now, kind=kind, job=job, detail=detail))
        if reg.enabled:
            reg.counter(f"arrivals.{kind}").inc()

    # carried-over per-tenant task machines (warm placement across epochs)
    warm: Dict[str, np.ndarray] = {}

    def residuals_at(t_abs: float) -> Dict[str, int]:
        """Iterations still owed per active job if the running epoch were
        cut at ``t_abs`` (full residuals when no epoch is running)."""
        res = {n: st.residual for n, st in active.items()}
        if epoch is not None:
            for ji, n in enumerate(epoch.mj.names):
                res[n] = max(res[n] - epoch.served_by(ji, t_abs), 0)
        return res

    def admission_check(a: JobArrival, t_abs: float) -> Tuple[bool, str]:
        """Pure predictive feasibility of admitting ``a`` at ``t_abs``
        against the current residual load.  Never mutates driver state."""
        if t_abs + solo[a.name] > a.deadline_s + _EPS:
            return False, "hopeless: solo makespan already misses the deadline"
        if not active:
            return True, "empty cluster, solo run meets the deadline"
        res = residuals_at(t_abs)
        members = [n for n in inc.names if res.get(n, 0) > 0]
        cand_jobs, cand_seeds, cand_names, cand_classes = [], [], [], []
        for n in members:
            job = inc.job(n)
            r = res[n]
            cand_jobs.append(
                job if r == job.n_iters else _with_iters(job, r)
            )
            cand_seeds.append(inc.token(n))
            cand_names.append(n)
            cand_classes.append(active[n].arrival.qos)
        cand_jobs.append(a.workload)
        # probe token: what the job WOULD get on admit — deterministic,
        # never consumed, so a rejection leaves the token sequence intact
        cand_seeds.append(inc._next_token)
        cand_names.append(a.name)
        cand_classes.append(a.qos)
        cand = merge_workloads(
            cand_jobs, job_seeds=cand_seeds, names=cand_names
        )
        try:
            p = ifs_placement(cand.workload, cluster, seed=cfg.seed)
        except ValueError:
            return False, "capacity: merged task set does not pack"
        a_idx = names.index(a.name)
        r = realize_merged(
            cand, seed=derive_seed(cfg.seed, SEED_NS_ADMIT, a_idx)
        )
        ec = merged_edge_classes(cand, cand_classes)
        sim = simulate_torch(
            cand.workload, cluster, p, r, policy=cfg.policy,
            shaping=cfg.shaping, edge_classes=ec, record=True,
            device=cfg.device,
        )
        mks = per_job_makespans(cand, sim)
        margin = 1.0 + cfg.admit_margin
        # the candidate must make its own deadline...
        if t_abs + mks[-1] * margin > a.deadline_s + _EPS:
            return False, (
                f"predicted completion {t_abs + mks[-1]:.2f} misses "
                f"deadline {a.deadline_s:.2f}"
            )
        # ...without pushing any admitted tenant past theirs
        for ji, n in enumerate(cand_names[:-1]):
            dl = active[n].arrival.deadline_s
            if t_abs + mks[ji] * margin > dl + _EPS:
                return False, (
                    f"would push admitted tenant {n!r} past its deadline"
                )
        return True, f"predicted completion {t_abs + mks[-1]:.2f}"

    def admit(a: JobArrival) -> None:
        inc.add_job(a.name, a.workload)
        st = _Active(arrival=a, outcome=outcomes[a.name],
                     residual=a.workload.n_iters)
        active[a.name] = st
        st.outcome.admitted = True
        st.outcome.t_admit = now

    def try_arrival(a: JobArrival, n_defers: int) -> bool:
        """Admission decision for one arrival; returns True on admit."""
        ok, why = admission_check(a, now)
        if ok:
            record_event("admit", a.name, why)
            outcomes[a.name].n_defers = n_defers
            admit(a)
            return True
        hopeless = why.startswith("hopeless")
        if n_defers >= cfg.max_defer or hopeless:
            record_event("reject", a.name, why)
            outcomes[a.name].n_defers = n_defers
            return False
        record_event("defer", a.name, why)
        deferred.append((n_defers + 1, a))
        return False

    def cut_epoch(t_abs: float, reason: str) -> None:
        """Commit the running epoch's progress up to ``t_abs``."""
        nonlocal epoch, epoch_idx
        served: Dict[str, int] = {}
        for ji, n in enumerate(epoch.mj.names):
            st = active[n]
            done = min(epoch.served_by(ji, t_abs), st.residual)
            served[n] = done
            st.residual -= done
            if st.residual == 0:
                st.outcome.t_complete = epoch.completion_abs(ji)
                record_event(
                    "complete", n, f"at {st.outcome.t_complete:.2f}"
                )
                inc.remove_job(n)
                warm.pop(n, None)
                del active[n]
        out.epochs.append(
            EpochRecord(
                start_s=epoch.start_s, end_s=t_abs, reason=reason,
                jobs=list(epoch.mj.names), served=served,
                replanned=epoch.replanned, migration_gb=epoch.migration_gb,
            )
        )
        if epoch.trace_row is not None:
            out.traces.append(epoch.trace_row)
        epoch = None
        epoch_idx += 1

    def build_epoch() -> _Epoch:
        """Merge + place + (warm re-plan) + simulate the active set."""
        mj = inc.merged({n: active[n].residual for n in inc.names})
        # warm placement: survivors keep their machines, newcomers get
        # IFS slots on the merged workload; fall back to pure IFS when
        # the carried-over packing no longer fits
        p = ifs_placement(mj.workload, cluster, seed=cfg.seed)
        y = p.y.copy()
        for ji, n in enumerate(mj.names):
            w = warm.get(n)
            if w is not None:
                off = mj.task_offsets[ji]
                y[off: off + len(w)] = w
        warm_p = Placement(y)
        demands = cluster.demand_matrix(mj.workload.tasks)
        if is_feasible(cluster, demands, warm_p):
            p = warm_p
        flows: List[MigrationFlow] = []
        replanned = False
        migration_gb = 0.0
        if cfg.replan and len(mj.names) > 0:
            rcfg = cfg.replan_config or ReplanConfig(
                budget=40, sim_iters=min(6, mj.workload.n_iters),
                shaping=cfg.shaping, seed=cfg.seed, policy=cfg.policy,
                device=cfg.device,
            )
            rp = Replanner(
                mj.workload, cluster, p.copy(), config=rcfg,
                draws_fn=lambda seed, n_it, n_d: [
                    inc.realize(
                        mj, seed=derive_seed(seed, SEED_NS_ADMIT, 10_000 + d),
                        n_iters=n_it,
                    )
                    for d in range(n_d)
                ],
            )
            rec = rp.replan(trigger="membership")
            p = rp.placement
            replanned = rec.replanned and rec.moved_tasks > 0
            migration_gb = rec.migration_gb
            flows = list(rec.flows) if replanned else []
        # discretionary migrations ride BELOW every tenant class
        mig_cls = max((a.arrival.qos for a in active.values()), default=0) + 1
        flows = [
            MigrationFlow(
                src=f.src, dst=f.dst, gb=f.gb, task=f.task,
                cls=mig_cls, deadline=f.deadline,
            )
            for f in flows
        ]
        for ji, n in enumerate(mj.names):
            off = mj.task_offsets[ji]
            warm[n] = p.y[off: off + mj.jobs[ji].J].copy()
        classes = [active[n].arrival.qos for n in mj.names]
        ec = merged_edge_classes(mj, classes)
        r = inc.realize(mj, seed=derive_seed(cfg.seed, SEED_NS_EPOCH, epoch_idx))
        # record=True always: per_job_iteration_ends needs the event log
        res = simulate_torch(
            mj.workload, cluster, p, r, policy=cfg.policy,
            migrations=flows or None, shaping=cfg.shaping, edge_classes=ec,
            record=True, device=cfg.device,
        )
        if cfg.escalate and cfg.shaping is not None:
            # deadline escalation: a background tenant this schedule would
            # push past its deadline gets class 0 for the epoch, then ONE
            # re-simulate.  Deterministic in the committed epoch alone.
            ends = per_job_iteration_ends(mj, res)
            late = [
                ji for ji, n in enumerate(mj.names)
                if classes[ji] > 0
                and now + float(ends[ji][-1]) > active[n].arrival.deadline_s + _EPS
            ]
            if late:
                for ji in late:
                    classes[ji] = 0
                    record_event(
                        "escalate", mj.names[ji],
                        "epoch schedule would miss the deadline; "
                        "riding class 0 this epoch",
                    )
                ec = merged_edge_classes(mj, classes)
                res = simulate_torch(
                    mj.workload, cluster, p, r, policy=cfg.policy,
                    migrations=flows or None, shaping=cfg.shaping,
                    edge_classes=ec, record=True, device=cfg.device,
                )
        trace_row = None
        if collect_traces:
            from ..obs.trace import ScheduleTrace

            trace_row = (
                ScheduleTrace.from_result(
                    res, mj.workload, cluster, p, r,
                    migrations=flows or None, shaping=cfg.shaping,
                    edge_classes=ec,
                ),
                list(mj.task_offsets),
                list(mj.names),
            )
        if reg.enabled:
            reg.counter("arrivals.epochs").inc()
            reg.gauge("arrivals.active_jobs").set(len(mj.names))
        return _Epoch(
            mj=mj, placement=p, start_s=now,
            iter_ends=per_job_iteration_ends(mj, res),
            replanned=replanned, migration_gb=migration_gb,
            trace_row=trace_row,
        )

    def retry_deferred() -> None:
        """Re-evaluate deferrals at a membership change (arrival order)."""
        nonlocal deferred
        todo, deferred = deferred, []
        for n_defers, a in sorted(todo, key=lambda x: names.index(x[1].name)):
            try_arrival(a, n_defers)

    while pending or deferred or active:
        if not active:
            # idle: jump to the next arrival (deferrals can only clear at
            # membership changes, which need an arrival to happen first —
            # on an empty cluster re-check them right away)
            if deferred and not pending:
                retry_deferred()
                if not active and deferred:
                    # nothing admitted on an EMPTY cluster: every retry
                    # was hopeless-or-capacity rejected; drain remaining
                    for n_defers, a in deferred:
                        record_event("reject", a.name, "undeliverable")
                        outcomes[a.name].n_defers = n_defers
                    deferred = []
                continue
            if not pending:
                break
            a = pending.pop(0)
            now = max(now, a.t_arrive)
            admitted = try_arrival(a, 0)
            if admitted:
                retry_deferred()
            continue
        if epoch is None:
            epoch = build_epoch()
        first_comp = min(
            epoch.completion_abs(ji) for ji in range(len(epoch.mj.names))
        )
        t_next = pending[0].t_arrive if pending else math.inf
        if t_next < first_comp - _EPS:
            # an arrival lands mid-epoch: evaluate it against the running
            # schedule.  Admission cuts the epoch; rejection/deferral
            # leaves it untouched (the byte-identical isolation invariant)
            a = pending.pop(0)
            now = max(now, t_next)
            if try_arrival(a, 0):
                cut_epoch(now, reason="arrival")
                retry_deferred()
            continue
        # next membership change is a completion
        now = first_comp
        cut_epoch(now, reason="completion" if pending or deferred or
                  len(epoch.mj.names) > 1 else "drain")
        retry_deferred()
    return out


def _with_iters(job: Workload, n: int) -> Workload:
    import dataclasses

    return dataclasses.replace(job, n_iters=n)


# ---------------------------------------------------------------------------
# Exclusive-ordering baselines
# ---------------------------------------------------------------------------
def run_ordering_baseline(
    stream: Sequence[JobArrival],
    cluster: ClusterSpec,
    order: str,
    *,
    seed: int = 0,
    policy: str = "oes",
    rr_quantum: int = 2,
    device: DeviceLike = None,
) -> SLOReport:
    """The same stream WITHOUT co-scheduling: one job on the cluster at a
    time, picked by ``order`` — ``"edf"`` (earliest deadline first),
    ``"sjf"`` (shortest remaining solo work first) or ``"rr"``
    (round-robin, ``rr_quantum`` iterations per turn).  Everything is
    admitted (no controller); a job cannot start before it arrives.  EDF
    and SJF are non-preemptive (run-to-completion); RR preempts on the
    quantum.  Each job runs under its own IFS placement with its own
    realization stream — the exclusive analogue of the service's merged
    epochs.  Every run is on ``device``."""
    if order not in ORDERINGS:
        raise ValueError(f"unknown order {order!r}; known: {ORDERINGS}")
    arrivals = sorted(stream, key=lambda a: (a.t_arrive, a.name))
    names = [a.name for a in arrivals]
    outcomes = {
        a.name: TenantOutcome(
            name=a.name, t_arrive=a.t_arrive, deadline_s=a.deadline_s,
            qos=a.qos, admitted=True, t_admit=a.t_arrive,
        )
        for a in arrivals
    }
    # per-job state: full-horizon realization windowed as quanta are served
    placements = {
        a.name: ifs_placement(a.workload, cluster, seed=seed) for a in arrivals
    }
    reals = {
        a.name: a.workload.realize(
            seed=derive_seed(seed, SEED_NS_SOLO, names.index(a.name))
        )
        for a in arrivals
    }
    for a in arrivals:
        outcomes[a.name].solo_makespan_s = simulate_torch(
            a.workload, cluster, placements[a.name], reals[a.name],
            policy=policy, device=device,
        ).makespan
    served = {a.name: 0 for a in arrivals}
    remaining = {a.name: a.workload.n_iters for a in arrivals}
    byname = {a.name: a for a in arrivals}
    queue: List[str] = []  # arrival order; rr rotates it
    unarrived = list(arrivals)
    now = 0.0
    while queue or unarrived:
        while unarrived and unarrived[0].t_arrive <= now + _EPS:
            queue.append(unarrived.pop(0).name)
        if not queue:
            now = max(now, unarrived[0].t_arrive)
            continue
        if order == "edf":
            pick = min(queue, key=lambda n: (byname[n].deadline_s, names.index(n)))
        elif order == "sjf":
            pick = min(
                queue,
                key=lambda n: (
                    outcomes[n].solo_makespan_s
                    * remaining[n] / byname[n].workload.n_iters,
                    names.index(n),
                ),
            )
        else:  # rr
            pick = queue[0]
        a = byname[pick]
        n_run = remaining[pick] if order != "rr" else min(
            rr_quantum, remaining[pick]
        )
        r = reals[pick].window(served[pick], served[pick] + n_run)
        res = simulate_torch(
            a.workload, cluster, placements[pick], r, policy=policy,
            device=device,
        )
        now += res.makespan
        served[pick] += n_run
        remaining[pick] -= n_run
        queue.remove(pick)
        if remaining[pick] == 0:
            outcomes[pick].t_complete = now
        else:
            queue.append(pick)  # rr: back of the line
    return SLOReport(tenants=[outcomes[n] for n in names])
