"""Makespan blame attribution: critical-path extraction + decomposition.

A copy of the JAX package's ``repro.obs.blame`` over the port's
``ScheduleTrace``.  It walks the recorded schedule backwards from the
span that *defines* the makespan, following each span's binding
predecessor — the dependency whose completion released it.  The engine
starts a task (or arms a flow) at the exact event its last dependency
clears, so each chain element's start coincides with its binding
predecessor's end (up to the engine's EPS) and the chain telescopes: the
makespan equals the sum of chain-span durations plus inter-span gaps *by
construction*, not approximately.

Each chain span's duration is then split into named components:

  ``compute``       nominal task execution (realization exec time)
  ``straggler``     realized minus nominal execution (trace slowdowns)
  ``transmission``  contention-free transfer time at the NIC capacities
                    in force when the flow started (``FlowSpan.ideal_s``)
  ``contention``    realized minus ideal transfer for TRAINING-class
                    flows — time lost to sharing NICs
  ``shaping``       the same overhang for background-class flows under a
                    shaping mode — time the policy *chose* to spend by
                    de-prioritising the flow
  ``dependency``    start-minus-predecessor-end gaps (plus the chain
                    root's release offset) — waiting on something that
                    is not on this machine's critical path

``components`` always sums to ``makespan`` within float tolerance (the
conservation invariant, pinned for the port by tests/test_torch_obs.py
on the golden matrix).  ``contention`` can go slightly negative when a
bandwidth trace *recovers* mid-flow (the flow beats the capacity it
started under); conservation still holds because the flow's full
realized duration is what enters the sum.

``critical_path_length`` (compute + transmission only) is the schedule's
dependency-chain lower bound: on a static cluster no schedule can beat
it, so it never exceeds the makespan.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple, Union

import numpy as np

from ..core.engine import CLASS_TRAINING
from .trace import FlowSpan, ScheduleTrace, TaskSpan

#: anything that can sit on the critical-path chain
Span = Union[TaskSpan, FlowSpan]

COMPONENTS = (
    "compute",
    "straggler",
    "transmission",
    "contention",
    "shaping",
    "dependency",
)


@dataclass
class BlameReport:
    makespan: float
    components: Dict[str, float]
    per_machine_contention: Dict[int, float]
    path: List[Span] = field(default_factory=list)

    @property
    def total(self) -> float:
        return float(sum(self.components.values()))

    @property
    def residual(self) -> float:
        """makespan - sum(components); ~0 by construction."""
        return self.makespan - self.total

    @property
    def critical_path_length(self) -> float:
        """Dependency-chain lower bound: pure compute + ideal transfer."""
        return self.components["compute"] + self.components["transmission"]

    def table(self, label: str = "blame") -> str:
        rows = [f"{label}: makespan = {self.makespan:.3f}s"]
        for k in COMPONENTS:
            v = self.components[k]
            pct = 100.0 * v / self.makespan if self.makespan else 0.0
            rows.append(f"  {k:<13s} {v:9.3f}s  ({pct:5.1f}%)")
        return "\n".join(rows)


def _index_spans(
    tr: ScheduleTrace,
) -> Tuple[Dict[Tuple[int, int], TaskSpan], Dict[Tuple[int, int], FlowSpan]]:
    tasks = {(s.task, s.iter): s for s in tr.tasks}
    flows = {(f.edge, f.iter): f for f in tr.flows}
    return tasks, flows


def _binding_pred(
    span: Span,
    tr: ScheduleTrace,
    tasks: Dict[Tuple[int, int], TaskSpan],
    flows: Dict[Tuple[int, int], FlowSpan],
) -> Optional[Span]:
    """The predecessor span whose completion released ``span`` (None at
    the chain root).  Candidates mirror the engine's release rules; the
    binding one is the latest-ending candidate."""
    wl = tr.workload
    cands: List[Span] = []
    if isinstance(span, TaskSpan):
        j, n = span.task, span.iter
        if n > 1 and (j, n - 1) in tasks:
            cands.append(tasks[(j, n - 1)])  # previous instance
        for e in wl.in_edges[j]:
            need = n - int(wl.edge_lag[e])
            if need < 1:
                continue
            f = flows.get((e, need))
            if f is not None:
                cands.append(f)  # remote in-edge delivery
            else:
                # local or zero-volume edge: delivered the instant the
                # source task finished
                s = tasks.get((int(wl.edge_src[e]), need))
                if s is not None:
                    cands.append(s)
        if n == 1:
            # first instance may be gated on migration flows
            for f in tr.flows:
                if f.gated_task == j:
                    cands.append(f)
    else:  # FlowSpan
        e, n = span.edge, span.iter
        if e >= wl.E:
            return None  # migration pseudo-flows release at t=0
        s = tasks.get((int(wl.edge_src[e]), n))
        if s is not None:
            cands.append(s)  # source instance produced the data
        f = flows.get((e, n - 1))
        if f is not None:
            cands.append(f)  # per-edge serialization: one instance in flight
    if not cands:
        return None
    return max(cands, key=lambda c: c.end)


def blame(tr: ScheduleTrace) -> BlameReport:
    """Critical-path blame decomposition of one recorded schedule."""
    tasks, flows = _index_spans(tr)
    spans: List[Span] = list(tr.tasks) + list(tr.flows)
    if not spans:
        return BlameReport(
            makespan=tr.makespan,
            components={k: 0.0 for k in COMPONENTS},
            per_machine_contention={},
        )
    comp = {k: 0.0 for k in COMPONENTS}
    per_machine: Dict[int, float] = {}

    # walk back from the makespan-defining span
    cur: Optional[Span] = max(spans, key=lambda s: s.end)
    chain: List[Span] = []
    seen: Set[int] = set()
    while cur is not None and id(cur) not in seen:
        seen.add(id(cur))
        chain.append(cur)
        pred = _binding_pred(cur, tr, tasks, flows)
        gap = cur.start - (pred.end if pred is not None else 0.0)
        comp["dependency"] += gap
        if isinstance(cur, TaskSpan):
            comp["compute"] += cur.nominal_s
            comp["straggler"] += cur.duration - cur.nominal_s
        else:
            ideal = cur.ideal_s
            comp["transmission"] += ideal
            over = cur.duration - ideal
            shaped_bg = (
                tr.shaping is not None and cur.cls > CLASS_TRAINING
            )
            comp["shaping" if shaped_bg else "contention"] += over
            # attribute the overhang to the bottleneck NIC's machine
            if tr.bw_trace is not None:
                bw_in, bw_out = tr.bw_trace.bw_at(cur.start)
            else:
                bw_in, bw_out = tr.cluster.bw_in, tr.cluster.bw_out
            bott = (
                cur.dst
                if float(bw_in[cur.dst]) <= float(bw_out[cur.src])
                else cur.src
            )
            per_machine[bott] = per_machine.get(bott, 0.0) + over
        cur = pred
    chain.reverse()
    return BlameReport(
        makespan=tr.makespan,
        components=comp,
        per_machine_contention=per_machine,
        path=chain,
    )


SERVICE_TENANT = -1  # blame key for spans owned by no tenant (service moves)


def blame_by_tenant(
    tr: ScheduleTrace, task_offsets: List[int]
) -> Dict[int, float]:
    """Split the critical-path makespan across tenants of a merged job.

    Walks the same binding-predecessor chain as ``blame`` but attributes
    each chain span's (release gap + duration) to the tenant that owns
    it: a TaskSpan to the job its task index falls in (searchsorted over
    ``task_offsets``), a FlowSpan to its SOURCE task's job, and a
    migration pseudo-flow (edge >= E) to the job of the task it gates —
    or to ``SERVICE_TENANT`` when it gates nothing, since an ungated
    state move is the service's own overhead, not any tenant's.

    The chain telescopes exactly as in ``blame``, so the values sum to
    ``tr.makespan`` at machine precision — the per-tenant split is a
    regrouping of the same conserved sum.  A tenant's share reads as "the
    seconds of the merged critical path spent inside (or waiting on) this
    tenant's work": the shared-cluster analogue of RapidGNN-style per-job
    efficiency accounting, and the number to show a tenant asking why the
    merged run finished when it did."""
    tasks, flows = _index_spans(tr)
    spans: List[Span] = list(tr.tasks) + list(tr.flows)
    if not spans:
        return {}
    wl = tr.workload
    bounds = np.asarray(list(task_offsets) + [wl.J])

    def tenant_of(span: Span) -> int:
        if isinstance(span, TaskSpan):
            t = span.task
        elif span.edge < wl.E:
            t = int(wl.edge_src[span.edge])
        elif span.gated_task >= 0:
            t = span.gated_task
        else:
            return SERVICE_TENANT
        return int(np.searchsorted(bounds, t, side="right") - 1)

    shares: Dict[int, float] = {}
    cur: Optional[Span] = max(spans, key=lambda s: s.end)
    seen: Set[int] = set()
    while cur is not None and id(cur) not in seen:
        seen.add(id(cur))
        pred = _binding_pred(cur, tr, tasks, flows)
        gap = cur.start - (pred.end if pred is not None else 0.0)
        key = tenant_of(cur)
        shares[key] = shares.get(key, 0.0) + gap + cur.duration
        cur = pred
    return shares


def combine(reports: List[BlameReport]) -> BlameReport:
    """Sum reports across intervals (scenario blame): components add, the
    conservation invariant carries over because each addend conserves."""
    comp = {k: float(sum(r.components[k] for r in reports)) for k in COMPONENTS}
    per_m: Dict[int, float] = {}
    for r in reports:
        for m, v in r.per_machine_contention.items():
            per_m[m] = per_m.get(m, 0.0) + v
    return BlameReport(
        makespan=float(sum(r.makespan for r in reports)),
        components=comp,
        per_machine_contention=per_m,
    )


def blame_delta(
    a: BlameReport, b: BlameReport, label_a: str = "a", label_b: str = "b"
) -> str:
    """Side-by-side table: where did ``b`` gain/lose time vs ``a``?  The
    per-component deltas sum to the makespan delta (both sides conserve)."""
    width = max(len(label_a), len(label_b), 9)
    head = (
        f"{'component':<13s} {label_a:>{width}s} {label_b:>{width}s} "
        f"{'delta':>9s}"
    )
    rows = [head, "-" * len(head)]
    for k in COMPONENTS:
        va, vb = a.components[k], b.components[k]
        rows.append(
            f"{k:<13s} {va:>{width}.3f} {vb:>{width}.3f} {vb - va:>+9.3f}"
        )
    rows.append("-" * len(head))
    rows.append(
        f"{'makespan':<13s} {a.makespan:>{width}.3f} {b.makespan:>{width}.3f} "
        f"{b.makespan - a.makespan:>+9.3f}"
    )
    return "\n".join(rows)
