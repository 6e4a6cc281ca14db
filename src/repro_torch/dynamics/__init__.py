"""Dynamics tier of the port: time-varying clusters + incremental re-planning.

``traces``    — piecewise-constant bandwidth/straggler realizations the
                torch engine consumes natively (``simulate_torch(...,
                trace=...)``);
``replan``    — ``Replanner``: warm-started, migration-aware incremental
                ETP on drift / epoch / join / leave;
``scenario``  — strategy evaluation (static vs replan vs oracle) against
                ground-truth drift traces.

The reference's arrival-driven service (``dynamics.arrivals``) is not
ported yet (ROADMAP Queue 1 item 5).
"""
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
