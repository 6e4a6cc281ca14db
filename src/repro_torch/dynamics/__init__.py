"""Dynamics tier of the port: time-varying clusters + incremental re-planning.

``traces``    — piecewise-constant bandwidth/straggler realizations the
                torch engine consumes natively (``simulate_torch(...,
                trace=...)``);
``replan``    — ``Replanner``: warm-started, migration-aware incremental
                ETP on drift / epoch / join / leave;
``scenario``  — strategy evaluation (static vs replan vs oracle) against
                ground-truth drift traces;
``arrivals``  — scheduler-as-a-service: arrival-driven multi-tenant
                streams with admission control, per-tenant QoS classes,
                epoch-based co-scheduling, and SLO accounting, plus the
                EDF/SJF/round-robin exclusive-ordering baselines.
"""
from .arrivals import (
    ORDERINGS,
    EpochRecord,
    JobArrival,
    ServiceConfig,
    ServiceEvent,
    ServiceOutcome,
    SLOReport,
    TenantOutcome,
    jain_index,
    run_ordering_baseline,
    run_service,
    solo_makespan,
)
from .replan import (
    ReplanConfig,
    ReplannerConfig,
    ReplanRecord,
    Replanner,
    annotate_deadlines,
    build_migration_flows,
    default_task_state_gb,
    migration_drain_bound,
    migration_time,
)
from .scenario import (
    STRATEGIES,
    IntervalOutcome,
    ScenarioOutcome,
    run_scenario,
)
from .traces import (
    BandwidthTrace,
    DynamicsEvent,
    constant_trace,
    drift_trace,
    relative_bw_drift,
    trace_from_events,
)

__all__ = [k for k in dir() if not k.startswith("_")]
