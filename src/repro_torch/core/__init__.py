"""DGTP core on PyTorch: the paper's planner on the torch engine.

Task placement (IFS/ETP), online execution & flow scheduling (OES + the
baseline policies) as one batched event program on a CUDA card (or the
CPU, when asked), with bandwidth traces, migration flows and traffic-class
shaping; the audit quantities (Delta, the Theorem-1 chain certificate,
traffic summary), the dataset traffic profiles, and the paper's
time-slotted Algorithm 1 as a host-side fidelity oracle.  The LM infeed
planner is ``repro_torch.core.infeed_planner``.
"""
from .analysis import (
    ChainCertificate,
    chain_lower_bound,
    max_degree,
    one_iteration_degrees,
    traffic_summary,
)
from .cluster import (
    ClusterSpec,
    Machine,
    Placement,
    TaskSpec,
    heterogeneous_cluster,
    is_feasible,
    testbed_cluster,
    violation_fraction,
)
from .dgtp import DEFAULT_N_CHAINS, Plan, plan, plan_baseline
from .engine import (
    CLASS_MIGRATION,
    CLASS_TRAINING,
    EPS,
    POLICY_NAMES,
    FlowLog,
    SHAPING_MODES,
    MigrationFlow,
    ScheduleResult,
    TaskEvent,
    check_migration_flows,
    expected_makespan,
    expected_makespan_many,
    mean_batch_makespans,
    monte_carlo_draws,
    resolve_device,
)
from .engine_torch import (
    PARITY_ATOL,
    PARITY_RTOL,
    simulate_batch_torch,
    simulate_torch,
)
from .oes_slotted import SlottedResult, simulate_slotted
from .placement import (
    ETPResult,
    distdgl_placement,
    etp_multichain,
    etp_search,
    group_move_candidates,
    ifs_placement,
    remap_after_leave,
    replan_after_failure,
)
from .profiles import (
    OGBN_PAPERS100M,
    OGBN_PRODUCTS,
    PROFILES,
    REDDIT,
    build_workload_from_profile,
)
from .workload import Edge, Realization, TrafficModel, Workload, build_gnn_workload

__all__ = [k for k in dir() if not k.startswith("_")]
