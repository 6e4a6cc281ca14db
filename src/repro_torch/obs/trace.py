"""Structured schedule traces: task/flow spans + NIC utilization timelines.

A copy of the JAX package's ``repro.obs.trace`` over the torch engine.
``ScheduleTrace.from_result`` lifts a *recorded* schedule
(``simulate_torch(..., record=True)``) into an analysable object:

  * one ``TaskSpan`` per task instance (machine, kind, realized vs
    nominal duration);
  * one ``FlowSpan`` per delivered remote flow — training edges AND
    migration pseudo-edges — carrying src/dst machines, volume, traffic
    class, deadline and the *ideal* (contention-free) transfer time at
    the capacities in force when the flow started;
  * per-machine NIC utilization step timelines derived from per-flow
    average rates (``gb / (end - start)``), whose time integral equals
    the bytes delivered through that NIC *exactly* — the same quantity
    the engine's ``utilization=True`` integrals report
    (``ScheduleResult.aggregates``) for runs that keep no flow log.

A run that was not recorded has ``flow_log is None``, and
``from_result`` raises a descriptive error for it instead of silently
producing an empty trace.  The trace reads one instance's result: a
recorded batch is lifted one result at a time.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.engine import EPS, MigrationFlow

#: flows shorter than this are treated as instantaneous for rate purposes
_MIN_DUR = 1e-12


@dataclass
class TaskSpan:
    task: int
    iter: int  # 1-based instance id
    start: float
    end: float
    machine: int
    kind: str
    name: str
    nominal_s: float  # realization exec time (no straggler slowdown)

    @property
    def duration(self) -> float:
        return self.end - self.start


@dataclass
class FlowSpan:
    edge: int  # < E: training edge id; >= E: migration pseudo-edge
    iter: int  # 1-based instance id (migrations always 1)
    start: float
    end: float
    src: int  # source machine
    dst: int  # destination machine
    gb: float
    cls: int
    name: str
    ideal_s: float  # gb / min(bw_in[dst], bw_out[src]) at flow start
    gated_task: int = -1  # migration gating (-1: none)
    deadline: float = float("inf")

    @property
    def duration(self) -> float:
        return self.end - self.start

    @property
    def is_migration(self) -> bool:
        return self.name.startswith("mig[")

    @property
    def avg_rate(self) -> float:
        """Average delivered rate in GB/s (0 for instantaneous flows)."""
        d = self.duration
        return self.gb / d if d > _MIN_DUR else 0.0


@dataclass
class ScheduleTrace:
    """A fully recorded schedule plus the context needed to interpret it."""

    makespan: float
    policy: str
    M: int
    machine_names: List[str]
    tasks: List[TaskSpan]
    flows: List[FlowSpan]
    shaping: Optional[str] = None
    # planner context threaded through for blame attribution; typed Any
    # (not object) because blame.py reaches into workload/cluster structure
    workload: Any = None
    realization: Any = None
    bw_trace: Any = None
    cluster: Any = None
    extras: dict = field(default_factory=dict)

    # -- construction -----------------------------------------------------
    @classmethod
    def from_result(
        cls,
        res: Any,
        workload: Any,
        cluster: Any,
        placement: Any,
        realization: Any,
        *,
        trace: Any = None,
        migrations: Optional[Sequence[MigrationFlow]] = None,
        shaping: Optional[str] = None,
        edge_classes: Any = None,
    ) -> "ScheduleTrace":
        """Build a trace from ``simulate_torch(..., record=True)`` output
        (one instance's ``ScheduleResult``).

        Raises ``ValueError`` for results without a flow log
        (``record=False``)."""
        if res.flow_log is None:
            raise ValueError(
                "ScheduleResult has no flow_log (flow_log is None): the run "
                "was not recorded — re-run simulate_torch / "
                "simulate_batch_torch with record=True, or read the "
                "engine's aggregate counters (utilization=True -> "
                "ScheduleResult.aggregates)."
            )
        y = placement.y
        names = workload.task_names()
        E = workload.E
        ec = np.zeros(E, dtype=np.int64)
        if edge_classes is not None:
            ec = np.asarray(edge_classes, dtype=np.int64)
        migs = list(migrations) if migrations else []

        def caps_at(t: float) -> Tuple[np.ndarray, np.ndarray]:
            if trace is not None:
                return trace.bw_at(t)
            return cluster.bw_in, cluster.bw_out

        tasks: List[TaskSpan] = []
        for ev in res.task_events:
            j = ev.task
            tasks.append(
                TaskSpan(
                    task=j,
                    iter=ev.iter,
                    start=ev.start,
                    end=ev.end,
                    machine=int(y[j]),
                    kind=workload.tasks[j].kind,
                    name=names[j],
                    nominal_s=float(realization.exec_times[j, ev.iter - 1]),
                )
            )

        flows: List[FlowSpan] = []
        for e, n, start, end in res.flow_log:
            bw_in, bw_out = caps_at(start)
            if e < E:
                src = int(y[workload.edge_src[e]])
                dst = int(y[workload.edge_dst[e]])
                gb = float(realization.volumes[e, n - 1])
                fcls = int(ec[e])
                name = (
                    f"{names[int(workload.edge_src[e])]}->"
                    f"{names[int(workload.edge_dst[e])]}"
                )
                gate, dl = -1, float("inf")
            else:
                f = migs[e - E]
                src, dst, gb = int(f.src), int(f.dst), float(f.gb)
                fcls = int(f.cls)
                name = f"mig[{src}->{dst}]"
                gate, dl = int(f.task), float(f.deadline)
            cap = min(float(bw_in[dst]), float(bw_out[src]))
            flows.append(
                FlowSpan(
                    edge=int(e),
                    iter=int(n),
                    start=float(start),
                    end=float(end),
                    src=src,
                    dst=dst,
                    gb=gb,
                    cls=fcls,
                    name=name,
                    ideal_s=gb / max(cap, EPS),
                    gated_task=gate,
                    deadline=dl,
                )
            )
        return cls(
            makespan=float(res.makespan),
            policy=res.policy,
            M=cluster.M,
            machine_names=[m.name for m in cluster.machines],
            tasks=tasks,
            flows=flows,
            shaping=shaping,
            workload=workload,
            realization=realization,
            bw_trace=trace,
            cluster=cluster,
        )

    # -- NIC utilization --------------------------------------------------
    def _machine_flows(self, machine: int, direction: str) -> List[FlowSpan]:
        if direction not in ("in", "out"):
            raise ValueError(f"direction must be 'in' or 'out', got {direction!r}")
        attr = "dst" if direction == "in" else "src"
        return [f for f in self.flows if getattr(f, attr) == machine]

    def utilization_timeline(
        self, machine: int, direction: str = "in"
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Step function of aggregate NIC rate (GB/s) on one machine.

        Returns ``(times, rates)`` with ``len(times) == len(rates) + 1``:
        ``rates[i]`` holds on ``[times[i], times[i+1])``.  Each flow
        contributes its average delivered rate over its span, so the
        integral of this step function equals the bytes moved through the
        NIC exactly (conservation invariant, tested).
        """
        fl = self._machine_flows(machine, direction)
        if not fl:
            return np.array([0.0, self.makespan]), np.array([0.0])
        pts = sorted({0.0, self.makespan} | {f.start for f in fl} | {f.end for f in fl})
        times = np.array(pts)
        rates = np.zeros(len(times) - 1)
        for f in fl:
            r = f.avg_rate
            if r <= 0.0:
                continue
            i0 = np.searchsorted(times, f.start)
            i1 = np.searchsorted(times, f.end)
            rates[i0:i1] += r
        return times, rates

    def utilization_integral(self, machine: int, direction: str = "in") -> float:
        """GB through the machine's NIC = integral of the rate timeline."""
        times, rates = self.utilization_timeline(machine, direction)
        return float(np.sum(rates * np.diff(times)))

    def delivered_gb(self, machine: int, direction: str = "in") -> float:
        """GB through the machine's NIC, summed per flow (ground truth)."""
        return float(sum(f.gb for f in self._machine_flows(machine, direction)))

    def busy_timeline(self, machine: int) -> float:
        """Seconds with >= 1 task running on ``machine`` (interval union) —
        the same quantity as the engine's ``busy_s`` integral."""
        ivs = sorted(
            (t.start, t.end) for t in self.tasks if t.machine == machine
        )
        total = 0.0
        cur_s: Optional[float] = None
        cur_e = 0.0
        for s, e in ivs:
            if cur_s is None:
                cur_s, cur_e = s, e
            elif s <= cur_e:
                cur_e = max(cur_e, e)
            else:
                total += cur_e - cur_s
                cur_s, cur_e = s, e
        if cur_s is not None:
            total += cur_e - cur_s
        return total

    def class_gb(self) -> Dict[int, float]:
        """Delivered GB per traffic class."""
        out: Dict[int, float] = {}
        for f in self.flows:
            out[f.cls] = out.get(f.cls, 0.0) + f.gb
        return out

    def aggregates(self) -> dict:
        """Same shape as the engine's ``utilization=True`` dict
        (``ScheduleResult.aggregates``), so the two observability paths
        are directly comparable."""
        return {
            "nic_in_gb": np.array(
                [self.delivered_gb(m, "in") for m in range(self.M)]
            ),
            "nic_out_gb": np.array(
                [self.delivered_gb(m, "out") for m in range(self.M)]
            ),
            "busy_s": np.array([self.busy_timeline(m) for m in range(self.M)]),
            "class_gb": self.class_gb(),
        }
