"""Theoretical quantities: max degree Delta (eq. 20), the Appendix-B chain
lower bound, the competitive-ratio certificate of Theorem 1, and the
traffic summary.

A copy of the JAX package's ``repro.core.analysis``.
``chain_lower_bound`` re-runs the proof's construction on a *recorded*
schedule (``record=True``: its task events and flow log): walk backwards
from the last-finishing task, at every step following whichever
dependency cleared last (a flow arrival, a blocked predecessor flow, a
local producer, or the task's own previous iteration).  The resulting
chain must execute sequentially under ANY schedule, so

    LB = sum(exec times on chain) + sum(d_q / min(B_in, B_out))

lower-bounds the offline optimum T*, and Theorem 1 guarantees
``T_OES <= Delta * T*``; hence the checkable certificate
``T_OES <= Delta * LB_chain`` must hold for every run.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from .cluster import ClusterSpec, Placement
from .engine import ScheduleResult
from .workload import Realization, Workload

TIME_EPS = 1e-6


def one_iteration_degrees(
    workload: Workload, placement: Placement, cluster: ClusterSpec
) -> Tuple[np.ndarray, np.ndarray]:
    """(Delta_in_hat[m], Delta_out_hat[m]) — counts of distinct inter-machine
    flow templates per machine in one iteration (includes the lag-1 PS->worker
    parameter flows, per the paper's F_one_iter definition)."""
    y = placement.y
    d_in = np.zeros(cluster.M, dtype=np.int64)
    d_out = np.zeros(cluster.M, dtype=np.int64)
    for e in range(workload.E):
        s, d = workload.edge_src[e], workload.edge_dst[e]
        if y[s] == y[d]:
            continue
        d_out[y[s]] += 1
        d_in[y[d]] += 1
    return d_in, d_out


def max_degree(
    workload: Workload, placement: Placement, cluster: ClusterSpec
) -> int:
    """Delta of eq. (20): the competitive ratio of OES."""
    d_in, d_out = one_iteration_degrees(workload, placement, cluster)
    return int(max(d_in.max(initial=0), d_out.max(initial=0)))


@dataclass
class ChainCertificate:
    lower_bound: float
    delta: int
    makespan: float
    chain_len: int
    p_sum: float
    flow_term: float

    @property
    def ratio(self) -> float:
        return self.makespan / max(self.lower_bound, 1e-12)

    @property
    def holds(self) -> bool:
        return self.makespan <= self.delta * self.lower_bound * (1 + 1e-6) + 1e-9

    @property
    def ratio_vs_guarantee(self) -> float:
        """How much slack vs the Delta guarantee (1.0 = at the bound)."""
        return self.ratio / max(self.delta, 1)


def chain_lower_bound(
    workload: Workload,
    cluster: ClusterSpec,
    placement: Placement,
    realization: Realization,
    result: ScheduleResult,
) -> ChainCertificate:
    """Appendix-B chain construction on a recorded schedule."""
    if not result.task_events:
        raise ValueError("run simulate_torch(..., record=True) to build the chain")
    y = placement.y
    src_t, dst_t, lag = workload.edge_src, workload.edge_dst, workload.edge_lag
    # indices for O(1) lookups
    task_end: Dict[Tuple[int, int], Tuple[float, float]] = {}
    for ev in result.task_events:
        task_end[(ev.task, ev.iter)] = (ev.start, ev.end)
    flow_by_edge: Dict[Tuple[int, int], Tuple[float, float]] = {}
    for (e, n, s, t) in result.flow_log:
        flow_by_edge[(e, n)] = (s, t)

    last = max(result.task_events, key=lambda ev: ev.end)
    p_sum = 0.0
    flow_term = 0.0
    chain_len = 0
    cur_task, cur_iter = last.task, last.iter
    guard = 0
    while True:
        guard += 1
        if guard > 10 * len(result.task_events) + 10:  # pragma: no cover
            raise RuntimeError("chain construction did not terminate")
        start, end = task_end[(cur_task, cur_iter)]
        p_sum += end - start
        chain_len += 1
        if start <= TIME_EPS:
            break
        # which dependency cleared last (at `start`)?
        nxt: Optional[Tuple[str, int, int]] = None
        for e in workload.in_edges[cur_task]:
            need = cur_iter - lag[e]
            if need <= 0:
                continue
            if y[src_t[e]] == y[dst_t[e]]:
                te = task_end.get((int(src_t[e]), int(need)))
                if te is not None and abs(te[1] - start) <= TIME_EPS:
                    nxt = ("task", int(src_t[e]), int(need))
                    break
            else:
                fl = flow_by_edge.get((e, int(need)))
                if fl is not None and abs(fl[1] - start) <= TIME_EPS:
                    nxt = ("flow", e, int(need))
                    break
        if nxt is None:
            # own previous iteration finished at `start`
            prev = task_end.get((cur_task, cur_iter - 1))
            if prev is None or abs(prev[1] - start) > 1e-3:
                # idle gap (should not happen under work-conserving OES);
                # close the chain conservatively here.
                break
            cur_iter -= 1
            continue
        if nxt[0] == "task":
            cur_task, cur_iter = nxt[1], nxt[2]
            continue
        # follow flows, hopping to blocked predecessor instances (Case 2)
        e, n = nxt[1], nxt[2]
        while True:
            chain_len += 1
            f_start, f_end = flow_by_edge[(e, n)]
            d = realization.volumes[e, n - 1]
            b = min(cluster.bw_in[int(y[dst_t[e]])], cluster.bw_out[int(y[src_t[e]])])
            flow_term += d / b
            producer = task_end.get((int(src_t[e]), n))
            if producer is not None and abs(producer[1] - f_start) <= TIME_EPS:
                cur_task, cur_iter = int(src_t[e]), n
                break  # Case 1: producer finished exactly at flow start
            prev_fl = flow_by_edge.get((e, n - 1))
            if prev_fl is not None and abs(prev_fl[1] - f_start) <= TIME_EPS:
                n -= 1  # Case 2: predecessor instance blocked us
                continue
            # Fallback: attribute to producer anyway (float ties)
            cur_task, cur_iter = int(src_t[e]), n
            break

    delta = max_degree(workload, placement, cluster)
    return ChainCertificate(
        lower_bound=p_sum + flow_term,
        delta=delta,
        makespan=result.makespan,
        chain_len=chain_len,
        p_sum=p_sum,
        flow_term=flow_term,
    )


def traffic_summary(
    workload: Workload, placement: Placement, realization: Realization
) -> Dict[str, float]:
    """Total / inter-machine traffic (GB) under a placement — the quantity
    task placement minimizes first-order."""
    y = placement.y
    remote = y[workload.edge_src] != y[workload.edge_dst]
    total = float(realization.volumes.sum())
    cross = float(realization.volumes[remote].sum())
    return {
        "total_gb": total,
        "inter_machine_gb": cross,
        "locality_fraction": 1.0 - cross / max(total, 1e-12),
    }
