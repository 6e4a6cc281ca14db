"""Paper-faithful time-slotted OES (Alg. 1), kept as the fidelity oracle.

A copy of the JAX package's ``repro.core.oes_slotted`` (numpy, on the
host; the same slot arithmetic).  This is a direct transcription of
Algorithm 1: unit time slots, F_act / F_pend flow sets, per-slot degree
computation (eq. 18/19) and the rate rule of line 21.  It is
O(T * (J + E)) and only used in tests on small jobs to certify that the
torch engine (``engine_torch.py``) produces the same schedules in the
slot->0 limit (tests assert agreement within discretisation error).

Slot semantics follow the pseudocode precisely:
  * line 2:   stores' iteration 1 starts at t=1;
  * line 7:   a task starts in slot t if it is "available" (all inputs
              delivered by end of t-1, own previous iteration done);
  * lines 8-13: flows of tasks that finished at t-1 enter F_act (or F_pend
              if their previous-iteration instance is still in flight);
  * lines 14-17: flows finished at t-1 promote their pending successors;
  * lines 18-21: every active flow transmits min(B_in/Δ_in, B_out/Δ_out)
              for one slot.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .cluster import ClusterSpec, Placement
from .engine import (
    CLASS_TRAINING,
    EPS as _ENG_EPS,
    SHAPING_MODES,
    MigrationFlow,
    check_edge_classes,
    check_migration_flows,
    escalated_level,
)
from .workload import Realization, Workload

if TYPE_CHECKING:  # layering: core never imports dynamics at runtime
    from numpy.typing import ArrayLike

    from ..dynamics.traces import BandwidthTrace

EPS = 1e-9


def _effective_classes(mode, cls, deadline, remaining, src_m, dst_m, bw_in, bw_out, now):
    """Class each flow is served in this slot: the declared classes, and
    under ``deadline`` a background flow whose slack is consumed promoted
    to ``escalated_level`` (the torch engine's rule, ``engine.py``)."""
    eff = np.asarray(cls, dtype=np.int64)
    if mode != "deadline":
        return eff
    lim = np.minimum(bw_in[dst_m], bw_out[src_m])
    need = remaining / np.maximum(lim, _ENG_EPS)
    urgent = (eff > CLASS_TRAINING) & ((deadline - now) <= need)
    if not urgent.any():
        return eff
    eff = eff.copy()
    eff[urgent] = escalated_level(eff)
    return eff


def _class_shaped_rates(cls, src_m, dst_m, bw_in, bw_out, minlength, base_call):
    """The per-class leftover-capacity loop: classes ascending, each rated
    by ``base_call(mask, rem_in, rem_out)`` against what the classes above
    left over, a single class short-circuiting to a full-capacity pass
    (``mask=None``)."""
    levels = np.unique(cls)
    if len(levels) == 1:
        return base_call(None, bw_in, bw_out)
    r = np.zeros(len(src_m))
    rem_in = bw_in.astype(np.float64)
    rem_out = bw_out.astype(np.float64)
    for i, c in enumerate(levels):
        m = cls == c
        sub = base_call(m, rem_in, rem_out)
        r[m] = sub
        if i + 1 < len(levels):
            rem_in -= np.bincount(dst_m[m], weights=sub, minlength=minlength)
            rem_out -= np.bincount(src_m[m], weights=sub, minlength=minlength)
            np.maximum(rem_in, 0.0, out=rem_in)
            np.maximum(rem_out, 0.0, out=rem_out)
    return r


@dataclass
class SlottedResult:
    makespan: float  # in slots (T_OES of Alg. 1)
    task_start: Dict[Tuple[int, int], int]  # (task, iter) -> slot


def simulate_slotted(
    workload: Workload,
    cluster: ClusterSpec,
    placement: Placement,
    realization: Realization,
    slot: float = 1.0,
    max_slots: int = 2_000_000,
    trace: Optional["BandwidthTrace"] = None,
    migrations: Optional[Sequence[MigrationFlow]] = None,
    shaping: Optional[str] = None,
    edge_classes: Optional["ArrayLike"] = None,
) -> SlottedResult:
    """``trace`` (``repro_torch.dynamics.traces.BandwidthTrace``) makes the oracle
    time-varying: slot ``t`` transmits with the bandwidth of the segment
    containing the slot's start time ``(t-1)*slot``, and a task started in
    slot ``t`` runs for ``ceil(exec * slow / slot)`` slots with the
    slowdown sampled at its start — the same start-time semantics as the
    event engine, so agreement still tightens as slot -> 0 (boundaries
    contribute at most one slot of discretisation error each).

    ``migrations`` (sequence of ``repro_torch.core.engine.MigrationFlow``) enters
    the active flow set in slot 1 and shares the line-21 degree-balanced
    rate rule with the training flows; a gated task is unavailable until
    the slot after its state flow drains — mirroring the event engine's
    release-at-t=0 + first-iteration gating, so slot->0 agreement holds for
    migration-loaded runs too.

    ``shaping`` (``None`` | ``"strict"`` | ``"deadline"``) mirrors the
    torch engine's class shaping over the line-21 rule: classes are
    served in ascending id order, each class degree-balanced against the
    capacity left over by the classes above it; ``"deadline"`` promotes a
    background flow strictly above class 0 once its deadline slack is
    consumed (EDF escalation).
    ``edge_classes`` ([E] int) assigns the workload's own flows to QoS
    classes.  Agreement with ``simulate_torch(..., policy="oes_strict",
    shaping=...)`` tightens as slot -> 0.  The oracle runs on the host:
    it takes no ``device``."""
    if shaping is not None and shaping not in SHAPING_MODES:
        raise ValueError(f"unknown shaping mode {shaping!r}; known: {SHAPING_MODES}")
    N = realization.n_iters
    J, E = workload.J, workload.E
    y = placement.y
    src_t, dst_t, lag = workload.edge_src, workload.edge_dst, workload.edge_lag
    vol = realization.volumes
    ex = realization.exec_times
    # exec times are rounded UP to whole slots, as Alg. 1's p_j are slots
    p = np.maximum(1, np.ceil(realization.exec_times / slot).astype(np.int64))
    bw_in = cluster.bw_in * slot  # GB transmittable per slot
    bw_out = cluster.bw_out * slot
    seg, n_segs, seg_times = 0, 1, None
    slow_cur = None
    if trace is not None:
        if trace.bw_in.shape[1] != cluster.M:
            raise ValueError(
                f"trace covers {trace.bw_in.shape[1]} machines but the "
                f"cluster has {cluster.M} — rebuild the trace after "
                "membership changes"
            )
        seg_times = np.asarray(trace.times, dtype=np.float64)
        n_segs = len(seg_times)
        bw_in = np.asarray(trace.bw_in[0], dtype=np.float64) * slot
        bw_out = np.asarray(trace.bw_out[0], dtype=np.float64) * slot
        slow_cur = np.asarray(trace.slow[0], dtype=np.float64)

    def p_of(j: int, n: int) -> int:
        if slow_cur is None:
            return int(p[j, n - 1])
        return max(1, int(np.ceil(ex[j, n - 1] * slow_cur[y[j]] / slot)))
    local = y[src_t] == y[dst_t]
    last_instance = N - lag

    # migration flows: active from slot 1, degree-balanced like any flow
    migs = check_migration_flows(migrations, cluster.M, J)
    ec = check_edge_classes(edge_classes, E)
    edge_cls = ec if ec is not None else np.zeros(E, dtype=np.int64)
    mig_rem: Dict[int, float] = {}
    mig_left = np.zeros(J, dtype=np.int64)
    for g, f in enumerate(migs):
        if f.src == f.dst or f.gb <= _ENG_EPS:
            continue  # nothing to ship: state already in place
        mig_rem[g] = float(f.gb)
        if f.task >= 0:
            mig_left[f.task] += 1

    done_slot = {}  # (task, iter) -> slot the task finished in
    done_iter = np.zeros(J, dtype=np.int64)
    running_until = np.zeros(J, dtype=np.int64)  # slot index task busy through
    running_iter = np.zeros(J, dtype=np.int64)
    task_start: Dict[Tuple[int, int], int] = {}

    # F_act: edge -> [iter, remaining]; F_pend: set of (edge, iter)
    f_act: Dict[int, List[float]] = {}
    f_pend: Set[Tuple[int, int]] = set()
    delivered = np.zeros(E, dtype=np.int64)
    finished_tasks_prev: List[Tuple[int, int]] = []
    finished_flows_prev: List[Tuple[int, int]] = []

    def available(j: int, n: int) -> bool:
        if n > N or running_until[j] > 0 or done_iter[j] != n - 1:
            return False
        if n == 1 and mig_left[j]:
            return False  # relocated: first iteration waits for its state
        for e in workload.in_edges[j]:
            need = n - lag[e]
            if need <= 0:
                continue
            if local[e]:
                if done_iter[src_t[e]] < need:
                    return False
            elif delivered[e] < need:
                return False
        return True

    # line 2: stores start at t = 1 (unless gated on inbound state)
    t = 0
    for j in range(J):
        if workload.kinds[j] == 0 and not mig_left[j]:  # store
            task_start[(j, 1)] = 1
            running_until[j] = 1 + p_of(j, 1) - 1
            running_iter[j] = 1

    for t in range(1, max_slots):
        # slot t spans ((t-1)*slot, t*slot]; sample the trace at its start
        if trace is not None:
            t_slot = (t - 1) * slot
            while seg + 1 < n_segs and seg_times[seg + 1] <= t_slot:
                seg += 1
                bw_in = np.asarray(trace.bw_in[seg], dtype=np.float64) * slot
                bw_out = np.asarray(trace.bw_out[seg], dtype=np.float64) * slot
                slow_cur = np.asarray(trace.slow[seg], dtype=np.float64)

        # lines 4-5: convergence check (migration state must have landed too)
        if bool(np.all(done_iter >= N)) and not f_act and not f_pend and not mig_rem:
            return SlottedResult(makespan=float(t - 1), task_start=task_start)

        # lines 8-13: flows of tasks that completed at t-1
        for (j, n) in finished_tasks_prev:
            for e in workload.out_edges[j]:
                if local[e] or n > last_instance[e]:
                    continue
                if vol[e, n - 1] <= EPS:
                    delivered[e] = max(delivered[e], n)
                    continue
                prev_inflight = (e in f_act) or ((e, n - 1) in f_pend)
                if n > 1 and (prev_inflight or delivered[e] < n - 1):
                    f_pend.add((e, n))
                else:
                    f_act[e] = [n, float(vol[e, n - 1])]
        finished_tasks_prev = []

        # lines 14-17: promote pending successors of flows finished at t-1
        for (e, n) in finished_flows_prev:
            if (e, n + 1) in f_pend:
                f_pend.discard((e, n + 1))
                f_act[e] = [n + 1, float(vol[e, n])]
        finished_flows_prev = []

        # line 7: start available tasks in slot t
        for j in range(J):
            n = int(done_iter[j]) + 1
            if available(j, n):
                task_start[(j, n)] = t
                running_until[j] = t + p_of(j, n) - 1
                running_iter[j] = n

        # lines 18-21: transmit for one slot with degree-balanced rates;
        # active migration flows share the NIC degrees with training flows
        # (unshaped) or are served from the leftover capacity per class
        # (shaped), mirroring the event engine's ShapedPolicy
        if f_act or mig_rem:
            edges = list(f_act.keys())
            mig_ids = list(mig_rem.keys())
            srcs = np.array(
                [y[src_t[e]] for e in edges] + [migs[g].src for g in mig_ids],
                dtype=np.int64,
            )
            dsts = np.array(
                [y[dst_t[e]] for e in edges] + [migs[g].dst for g in mig_ids],
                dtype=np.int64,
            )
            if shaping is None:
                d_out = np.bincount(srcs, minlength=cluster.M)
                d_in = np.bincount(dsts, minlength=cluster.M)
                rate = np.minimum(
                    bw_in[dsts] / d_in[dsts], bw_out[srcs] / d_out[srcs]
                )
            else:
                cls_arr = np.concatenate(
                    [edge_cls[edges].astype(np.int64) if edges else
                     np.zeros(0, dtype=np.int64),
                     np.array([migs[g].cls for g in mig_ids], dtype=np.int64)]
                )
                if shaping == "deadline" and mig_ids:
                    rem_arr = np.array(
                        [f_act[e][1] for e in edges] + [mig_rem[g] for g in mig_ids]
                    )
                    dl_arr = np.array(
                        [np.inf] * len(edges)
                        + [migs[g].deadline for g in mig_ids]
                    )
                    # the torch engine's escalation rule: bw arrays here
                    # are GB per SLOT, so rescale to GB/s for the
                    # seconds-based slack test
                    cls_arr = _effective_classes(
                        "deadline", cls_arr, dl_arr, rem_arr, srcs, dsts,
                        bw_in / slot, bw_out / slot, (t - 1) * slot,
                    )

                # the leftover-capacity loop, the base rule being line
                # 21's degree-balanced share; classes were already
                # escalated above
                def line21(m, rem_in_cap, rem_out_cap):
                    sm = srcs if m is None else srcs[m]
                    dm = dsts if m is None else dsts[m]
                    d_out = np.bincount(sm, minlength=cluster.M)
                    d_in = np.bincount(dm, minlength=cluster.M)
                    return np.minimum(
                        rem_in_cap[dm] / d_in[dm], rem_out_cap[sm] / d_out[sm]
                    )

                rate = _class_shaped_rates(
                    cls_arr, srcs, dsts, bw_in, bw_out, cluster.M, line21,
                )
            for i, e in enumerate(edges):
                f_act[e][1] -= rate[i]
                if f_act[e][1] <= EPS:
                    n = int(f_act[e][0])
                    delivered[e] = n
                    del f_act[e]
                    finished_flows_prev.append((e, n))
            for i, g in enumerate(mig_ids):
                mig_rem[g] -= rate[len(edges) + i]
                if mig_rem[g] <= EPS:
                    del mig_rem[g]
                    tsk = migs[g].task
                    if tsk >= 0:
                        # gated task becomes available the NEXT slot, the
                        # same end-of-slot delivery rule as line 14-17 flows
                        mig_left[tsk] -= 1

        # task completions at end of slot t
        for j in range(J):
            if running_until[j] == t:
                n = int(running_iter[j])
                done_iter[j] = n
                running_until[j] = 0
                finished_tasks_prev.append((j, n))

    raise RuntimeError("slotted OES did not converge within max_slots")
