"""DGTP (Alg. 4): ETP placement search + OES online scheduling, end to end.

The port of the JAX package's ``repro.core.dgtp``.  ``plan()`` searches a
placement with the multi-chain ETP on the torch engine and commits the
schedule for one realization on the same engine, on ``device`` (default:
the CUDA card), recorded: its task events and flow log give the
Theorem-1 chain certificate (``Plan.certificate``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from .analysis import ChainCertificate, chain_lower_bound, max_degree, traffic_summary
from .cluster import ClusterSpec, Placement
from .engine import DeviceLike, ScheduleResult, resolve_device
from .engine_torch import simulate_torch
from .placement import ETPResult, distdgl_placement, etp_multichain, ifs_placement
from .workload import Realization, Workload

# Default ETP chain count per device type.  cpu: 8, the reference numpy
# engine's default, so a CPU plan walks the reference's chains.  cuda: 16,
# the reference's value for its batched accelerator engine (wider batches
# at the same budget); not yet re-derived from a sweep on the card.
DEFAULT_N_CHAINS = {"cpu": 8, "cuda": 16}


@dataclass
class Plan:
    placement: Placement
    schedule: ScheduleResult
    certificate: ChainCertificate
    etp: Optional[ETPResult]
    delta: int
    traffic: dict


def plan(
    workload: Workload,
    cluster: ClusterSpec,
    *,
    realization: Optional[Realization] = None,
    budget: int = 1000,
    mu: float = 1.0,
    beta: float = 0.1,
    sim_iters: int = 20,
    seed: int = 0,
    policy: str = "oes",
    search: bool = True,
    time_budget_s: Optional[float] = None,
    n_chains: Optional[int] = None,
    device: DeviceLike = None,
) -> Plan:
    """Run DGTP: search placement (ETP) then schedule online (OES).

    Default search is multi-chain: one chain from IFS, one warm-started
    from the DistDGL colocation heuristic, the rest from random IFS machine
    orders; the chains advance in lock-step with their candidate
    placements evaluated in one batched simulation per step.  ``device``
    is where every simulation runs and picks the ``n_chains`` default
    (``DEFAULT_N_CHAINS``)."""
    realization = realization or workload.realize(seed=seed)
    dev = resolve_device(device)
    if n_chains is None:
        n_chains = DEFAULT_N_CHAINS[dev.type]
    etp: Optional[ETPResult] = None
    if search:
        etp = etp_multichain(
            workload,
            cluster,
            n_chains=n_chains,
            budget=budget,
            mu=mu,
            beta=beta,
            sim_iters=sim_iters,
            seed=seed,
            policy=policy,
            time_budget_s=time_budget_s,
            device=dev,
        )
        placement = etp.placement
    else:
        placement = ifs_placement(workload, cluster, seed=seed)
    schedule = simulate_torch(
        workload, cluster, placement, realization, policy=policy, record=True,
        device=dev,
    )
    return Plan(
        placement=placement,
        schedule=schedule,
        certificate=chain_lower_bound(
            workload, cluster, placement, realization, schedule
        ),
        etp=etp,
        delta=max_degree(workload, placement, cluster),
        traffic=traffic_summary(workload, placement, realization),
    )


def plan_baseline(
    workload: Workload,
    cluster: ClusterSpec,
    *,
    baseline: str,
    realization: Optional[Realization] = None,
    seed: int = 0,
    device: DeviceLike = None,
) -> Plan:
    """Baselines of §VI-B: 'distdgl' (own placement + FIFO flows);
    'omcoflow' / 'mrtf' (IFS placement for a placement-free comparison)."""
    realization = realization or workload.realize(seed=seed)
    if baseline == "distdgl":
        placement = distdgl_placement(workload, cluster)
        policy = "fifo"
    else:
        placement = ifs_placement(workload, cluster, seed=seed)
        policy = baseline
    schedule = simulate_torch(
        workload, cluster, placement, realization, policy=policy, record=True,
        device=device,
    )
    return Plan(
        placement=placement,
        schedule=schedule,
        certificate=chain_lower_bound(
            workload, cluster, placement, realization, schedule
        ),
        etp=None,
        delta=max_degree(workload, placement, cluster),
        traffic=traffic_summary(workload, placement, realization),
    )
