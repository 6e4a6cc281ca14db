"""Cluster model for DGTP planning.

A copy of the JAX package's ``repro.core.cluster``: the port imports
nothing of that package, so it keeps its own copy, with the same
arrays and the same numpy random streams.

Machines carry R resource types (cpu / gpu / mem, extensible) plus ingress
and egress NIC bandwidth.  Tasks are the paper's four kinds: graph store
servers, samplers, workers and parameter servers; each kind has a fixed
resource demand vector and a per-iteration execution-time profile.

Units used throughout core/: seconds for time, gigabytes (GB) for data,
GB/s for bandwidth.  All task/machine handles are integer indices into the
spec arrays for speed; human-readable names are kept alongside for logging.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .units import GBps

# Canonical task kinds (paper §III-A).
STORE = "store"
SAMPLER = "sampler"
WORKER = "worker"
PS = "ps"
KINDS = (STORE, SAMPLER, WORKER, PS)


@dataclass(frozen=True)
class Machine:
    """A physical machine: resource capacities + NIC bandwidths (GB/s)."""

    name: str
    resources: Dict[str, float]
    bw_in: GBps
    bw_out: GBps

    def cap(self, r: str) -> float:
        return float(self.resources.get(r, 0.0))


@dataclass(frozen=True)
class TaskSpec:
    """One task instance (not per-iteration copy): kind + demand vector."""

    name: str
    kind: str
    demand: Dict[str, float]
    # For workers: the sampler indices feeding it are derived in workload.py.


@dataclass
class ClusterSpec:
    """The full cluster: machines plus derived dense arrays."""

    machines: List[Machine]

    def __post_init__(self) -> None:
        self.resource_types: List[str] = sorted(
            {r for m in self.machines for r in m.resources}
        )
        self.M = len(self.machines)
        self.R = len(self.resource_types)
        self.cap = np.array(
            [[m.cap(r) for r in self.resource_types] for m in self.machines],
            dtype=np.float64,
        )  # [M, R]
        self.bw_in = np.array([m.bw_in for m in self.machines], dtype=np.float64)
        self.bw_out = np.array([m.bw_out for m in self.machines], dtype=np.float64)

    def demand_matrix(self, tasks: Sequence[TaskSpec]) -> np.ndarray:
        """[J, R] demand matrix aligned with self.resource_types."""
        return np.array(
            [[float(t.demand.get(r, 0.0)) for r in self.resource_types] for t in tasks],
            dtype=np.float64,
        )

    def without_machine(self, m: int) -> "ClusterSpec":
        """Cluster after machine ``m`` fails (fault-tolerance re-plan path)."""
        keep = [mm for i, mm in enumerate(self.machines) if i != m]
        return ClusterSpec(machines=keep)

    def with_machine(self, machine: Machine) -> "ClusterSpec":
        """Cluster after ``machine`` joins (elastic scale-up re-plan path);
        the new machine takes index ``M``."""
        return ClusterSpec(machines=self.machines + [machine])

    def with_bandwidth(
        self, bw_in: Sequence[float], bw_out: Optional[Sequence[float]] = None
    ) -> "ClusterSpec":
        """Same machines, different NIC bandwidths — the planner-side
        snapshot of a time-varying cluster."""
        if bw_out is None:
            bw_out = bw_in
        if len(bw_in) != self.M or len(bw_out) != self.M:
            raise ValueError("bandwidth vectors must have one entry per machine")
        machines = [
            dataclasses.replace(m, bw_in=float(bi), bw_out=float(bo))
            for m, bi, bo in zip(self.machines, bw_in, bw_out)
        ]
        return ClusterSpec(machines=machines)


@dataclass
class Placement:
    """Task -> machine assignment. ``y[j] = m``."""

    y: np.ndarray  # int64 [J]

    def copy(self) -> "Placement":
        return Placement(self.y.copy())

    def __eq__(self, other: object) -> bool:  # pragma: no cover - trivial
        return isinstance(other, Placement) and np.array_equal(self.y, other.y)

    def key(self) -> bytes:
        """Hashable identity for memoising placement costs during search."""
        return self.y.tobytes()


def placement_usage(
    cluster: ClusterSpec, demands: np.ndarray, placement: Placement
) -> np.ndarray:
    """Per-machine, per-resource usage [M, R] under ``placement``."""
    usage = np.zeros((cluster.M, cluster.R), dtype=np.float64)
    np.add.at(usage, placement.y, demands)
    return usage


def violation_fraction(
    cluster: ClusterSpec, demands: np.ndarray, placement: Placement
) -> float:
    """Sum of capacity-violation percentages over machines x resources.

    This is the penalty term of the paper's cost function (eq. 21):
    ``sum_m,r max((usage - C) / C, 0)``.  Machines with zero capacity for a
    resource count as infinitely violated if any demand lands there; we map
    that to the demand itself (large but finite) to keep the search smooth.
    """
    usage = placement_usage(cluster, demands, placement)
    cap = cluster.cap
    with np.errstate(divide="ignore", invalid="ignore"):
        frac = np.where(cap > 0, (usage - cap) / np.where(cap > 0, cap, 1.0), usage)
    return float(np.maximum(frac, 0.0).sum())


def is_feasible(
    cluster: ClusterSpec,
    demands: np.ndarray,
    placement: Placement,
    slack: float = 0.0,
) -> bool:
    """Check capacity constraints (2), relaxed by ``slack`` (paper's mu)."""
    usage = placement_usage(cluster, demands, placement)
    return bool(np.all(usage <= cluster.cap * (1.0 + slack) + 1e-9))


def heterogeneous_cluster(
    m: int,
    *,
    seed: int = 0,
    mem_range: Tuple[float, float] = (32.0, 128.0),
    cpu_range: Tuple[int, int] = (8, 32),
    gpu_range: Tuple[int, int] = (1, 4),
    bw_choices: Sequence[float] = (1.25, 2.5, 6.25),  # 10 / 20 / 50 Gbps in GB/s
) -> ClusterSpec:
    """Random heterogeneous cluster matching the paper's simulation setup
    (§VI-B): mem in [32,128] GB, cpu cores in [4,16] physical = [8,32]
    logical (demands are quoted in logical cores, as on the testbed),
    gpu in [1,4], NIC in {10, 20, 50} Gbps."""
    rng = np.random.default_rng(seed)
    machines = []
    for i in range(m):
        bw = float(rng.choice(np.asarray(bw_choices)))
        machines.append(
            Machine(
                name=f"m{i}",
                resources={
                    "mem": float(rng.integers(int(mem_range[0]), int(mem_range[1]) + 1)),
                    "cpu": float(rng.integers(cpu_range[0], cpu_range[1] + 1)),
                    "gpu": float(rng.integers(gpu_range[0], gpu_range[1] + 1)),
                },
                bw_in=bw,
                bw_out=bw,
            )
        )
    return ClusterSpec(machines=machines)


def testbed_cluster() -> ClusterSpec:
    """The paper's 4-server testbed (§VI-A): 8-core (16 logical) E5-1660,
    2 GPUs, 48 GB RAM, 50 Gbps NIC with two servers limited to 10 Gbps.
    Task demands are quoted in *logical* cores (paper: "1 logical CPU
    core"), so capacity is 16."""
    machines = []
    for i in range(4):
        bw = 6.25 if i < 2 else 1.25  # GB/s (50 / 10 Gbps)
        machines.append(
            Machine(
                name=f"server{i}",
                resources={"mem": 48.0, "cpu": 16.0, "gpu": 2.0},
                bw_in=bw,
                bw_out=bw,
            )
        )
    return ClusterSpec(machines=machines)
