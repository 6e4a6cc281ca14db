"""The batched event engine as an eager PyTorch program.

The counterpart of the JAX package's ``repro.core.engine_jax``: one
lock-step event program over ``B`` independent (placement, realization)
instances, with the same event calculus as the numpy reference engine:

  * one outer iteration = one lock-step event per still-alive instance:
    a SETTLE fixpoint (task completions -> flow completions -> flow arming
    incl. zero-volume cascades -> task starts, repeated until nothing
    changes at the current instant) followed by an ADVANCE step (rate
    solve, next-event time over task ends and flow drains, remaining-
    volume decrement);
  * all five built-in rate policies (oes / oes_strict / fifo / mrtf /
    omcoflow) are masked ``[B, E]`` tensor programs over the per-instance
    ``[B, M]`` NIC capacity rows.  The sequential waterfill of fifo and
    mrtf runs in ``repro_torch.kernels.waterfill``: a CUDA kernel on the
    card, its plain torch version on the CPU.

This slice covers the unshaped, static-cluster, migration-free program,
with or without ``record``.  Bandwidth traces, traffic-class shaping,
migration flows and utilization aggregates are not accepted yet.

Precision and parity: float64 throughout, agreeing with the numpy engine
on makespans and task-start schedules at ``PARITY_RTOL`` / ``PARITY_ATOL``
(the JAX engine's contract).  Sums run in another order than numpy's
(scatter-add segment sums; on the card in atomic order), so schedules can
drift by a few ULPs per event.  By design, as in the JAX engine,
``n_events`` counts lock-step iterations and ``flow_log`` is ``None``.

Host synchronisation: PyTorch runs eagerly, so every loop condition the
JAX program evaluated on the device is a device-to-host copy here.  The
outer loop tests for termination every ``_CHECK_EVERY`` iterations
(``advance`` freezes finished instances, so the extra iterations change
nothing).  The oes progressive filling tests for an empty flow set after
every round (``_OES_CHECK_EVERY``).  The settle fixpoint stays exact:
workloads that can cascade test for a change after every settle round;
the others settle in one.  Each choice was timed on an H100 against its
alternatives with ``engine_probe.py``; PERF.md has the numbers.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from .cluster import ClusterSpec, Placement
from .engine import (
    EPS,
    OMCOFLOW_ROUNDS,
    DeviceLike,
    ScheduleResult,
    TaskEvent,
    policy_name,
    resolve_device,
)
from .workload import Realization, Workload
from ..kernels.waterfill import waterfill_fill

# Pinned agreement tolerance with the numpy engine, the JAX engine's
# (repro.core.engine_jax.PARITY_RTOL / PARITY_ATOL): both run float64 and
# the same arithmetic, in another summation order.
PARITY_RTOL = 1e-6
PARITY_ATOL = 1e-9

# outer iterations between host-side termination checks
_CHECK_EVERY = 32
# oes filling rounds between host-side checks for an empty flow set
_OES_CHECK_EVERY = 1

F64 = torch.float64
INF = float("inf")


class _Program:
    """The lock-step program for one batch: static tensors, the mutable
    state and the rate rules.  State tensors are rebound, never updated
    in place, so each step reads exactly the JAX program's values."""

    def __init__(
        self,
        *,
        dev: torch.device,
        policy: str,
        record: bool,
        no_cascade: bool,
        vol: np.ndarray,  # [B, E, N] f64
        ex: np.ndarray,  # [B, J, N] f64
        src_m: np.ndarray,  # [B, E] machine per flow column
        dst_m: np.ndarray,  # [B, E]
        src_t: np.ndarray,  # [E] task ids
        dst_t: np.ndarray,  # [E]
        lag: np.ndarray,  # [E]
        bw_in: np.ndarray,  # [M]
        bw_out: np.ndarray,  # [M]
    ) -> None:
        B, E, N = vol.shape
        J = ex.shape[1]
        M = len(bw_in)
        self.B, self.E, self.J, self.N, self.M = B, E, J, N, M
        self.policy = policy
        self.record = record
        self.no_cascade = no_cascade

        def on(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
            return torch.from_numpy(np.array(a, order="C")).to(dev, dtype)

        i64 = torch.int64
        self.vol = on(vol, F64)
        self.ex = on(ex, F64)
        self.src_mx = on(src_m, i64)
        self.dst_mx = on(dst_m, i64)
        # the waterfill kernel takes int32 machine ids
        self.src_mx32 = self.src_mx.to(torch.int32)
        self.dst_mx32 = self.dst_mx.to(torch.int32)
        self.local = self.src_mx == self.dst_mx
        self.armable = ~self.local
        self.src_t = on(src_t, i64)
        self.dst_t = on(dst_t, i64)
        self.lag = on(lag, i64)
        self.last = on(N - lag, i64)  # last instance of each edge
        # static in-edge incidence: in_adj[e, j] = 1 iff edge e feeds task
        # j.  The dependency check counts violated in-edges with one
        # float64 matmul, exact for any count.
        in_adj = np.zeros((E, J), dtype=np.float64)
        in_adj[np.arange(E), dst_t] = 1.0
        self.in_adj = on(in_adj, F64)
        # omcoflow coflow ids (dst task instance) stay below this bound
        self.n_groups = int(J * (N + 2) + (lag.max() if E else 0) + 2)
        self.iter_ids = torch.arange(N, device=dev)
        # static cluster: every instance sees the same capacity rows
        self.cap_in = on(np.broadcast_to(bw_in, (B, M)), F64)
        self.cap_out = on(np.broadcast_to(bw_out, (B, M)), F64)
        # both NIC sides on one axis, so one scatter or gather serves both:
        # column m is machine m's ingress, column M + m its egress; flow e
        # uses ingress dst[e] and egress src[e]
        self.nic_idx = torch.cat([self.dst_mx, self.src_mx + M], 1)  # [B, 2E]
        self.cap = torch.cat([self.cap_in, self.cap_out], 1)  # [B, 2M]
        # what the static capacities give each flow, computed once
        self.cap_fd = self.cap_in.gather(1, self.dst_mx)  # its ingress cap
        self.cap_fs = self.cap_out.gather(1, self.src_mx)  # its egress cap
        self.lim = torch.minimum(self.cap_fd, self.cap_fs).clamp_min(EPS)
        self.ref_b = torch.minimum(self.cap_in.amax(1), self.cap_out.amax(1))

        z = dict(device=dev)
        self.t = torch.zeros(B, dtype=F64, **z)
        self.nev = torch.zeros(B, dtype=i64, **z)
        self.stuck = torch.zeros(B, dtype=torch.bool, **z)
        self.delivered = torch.zeros(B, E, dtype=i64, **z)
        # completion threshold EPS*max(1, vol) of the in-flight instance
        self.thresh = torch.zeros(B, E, dtype=F64, **z)
        self.remaining = torch.zeros(B, E, dtype=F64, **z)
        self.release = torch.zeros(B, E, dtype=F64, **z)
        self.active = torch.zeros(B, E, dtype=torch.bool, **z)
        self.done = torch.zeros(B, J, dtype=i64, **z)
        self.running = torch.zeros(B, J, dtype=torch.bool, **z)
        self.tend = torch.full((B, J), INF, dtype=F64, **z)
        rec_shape = (B, J, N) if record else (1, 1, 1)
        self.start_rec = torch.full(rec_shape, float("nan"), dtype=F64, **z)
        self.end_rec = torch.full(rec_shape, float("nan"), dtype=F64, **z)

        self.rates = {
            "oes": self.rates_oes,
            "oes_strict": self.rates_oes_strict,
            "fifo": self.rates_waterfill,
            "mrtf": self.rates_waterfill,
            "omcoflow": self.rates_omcoflow,
        }[policy]

    # ---- per-NIC segment sums and their per-flow gathers ----
    def nic_sum(self, vals: torch.Tensor) -> torch.Tensor:
        """[B, E] per-flow values -> [B, 2M] sums per NIC (ingress, egress)."""
        v = vals.to(F64)
        out = torch.zeros(self.B, 2 * self.M, dtype=F64, device=v.device)
        return out.scatter_add_(1, self.nic_idx, torch.cat([v, v], 1))

    def per_flow(self, nic: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B, 2M] per-NIC values -> each flow's (ingress, egress) value."""
        g = nic.gather(1, self.nic_idx)
        return g[:, : self.E], g[:, self.E :]

    # ---- rate policies: masked [B, E] programs over [B, M] caps ----
    def rates_oes_strict(self, mask: torch.Tensor) -> torch.Tensor:
        d_in, d_out = self.per_flow(self.nic_sum(mask))
        r = torch.minimum(
            self.cap_fd / d_in.clamp_min(1.0), self.cap_fs / d_out.clamp_min(1.0)
        )
        return torch.where(mask, r, 0.0)

    def oes_round(
        self, r: torch.Tensor, rem: torch.Tensor, unfrozen: torch.Tensor,
        live: torch.Tensor, flows: torch.Tensor,
    ) -> Tuple[torch.Tensor, ...]:
        """One progressive-filling round: each live instance raises its
        unfrozen flows by ITS OWN bottleneck increment and freezes the
        flows of the NICs that saturate.  A round on an empty flow set
        changes nothing (the increment is inf, so ``live`` goes false)."""
        cnt = self.nic_sum(flows)
        has = cnt > 0
        inc_b = torch.where(has, rem / cnt.clamp_min(1.0), INF).amin(1)
        live = live & torch.isfinite(inc_b)
        flows = flows & live[:, None]
        r = r + torch.where(flows, inc_b[:, None], 0.0)
        rem = rem - torch.where(live, inc_b, 0.0)[:, None] * cnt
        sat_d, sat_s = self.per_flow((rem <= EPS) & has)
        newly = flows & (sat_d | sat_s)
        live = live & newly.any(1)
        unfrozen = unfrozen & ~newly
        flows = unfrozen & live[:, None]
        return r, rem, unfrozen, live, flows

    def rates_oes(self, mask: torch.Tensor) -> torch.Tensor:
        # lock-step progressive filling: at most 4*M rounds, ending early
        # once no instance has a flow left (tested every _OES_CHECK_EVERY
        # rounds), as in the JAX program
        live = torch.ones(self.B, dtype=torch.bool, device=mask.device)
        state = (torch.zeros_like(self.remaining), self.cap, mask, live, mask)
        for i in range(4 * self.M):
            state = self.oes_round(*state)
            if (i + 1) % _OES_CHECK_EVERY == 0 and not bool(state[4].any()):
                break
        return torch.where(mask, state[0], 0.0)

    def rates_waterfill(self, mask: torch.Tensor) -> torch.Tensor:
        if self.policy == "fifo":
            key = torch.where(mask, self.release, INF)
        else:  # mrtf: remaining time at the best rate the caps allow
            key = torch.where(mask, self.remaining / self.lim, INF)
        # stable, like jnp.argsort: flows armed at the same instant share
        # a fifo key and keep their column order
        order = torch.argsort(key, dim=1, stable=True)
        return waterfill_fill(
            order.to(torch.int32), self.src_mx32, self.dst_mx32, mask,
            self.cap_in, self.cap_out,
        )

    def rates_omcoflow(self, mask: torch.Tensor) -> torch.Tensor:
        pred = self.remaining.clamp_min(EPS) / self.lim
        w = torch.where(mask, 1.0 / pred, 0.0)
        # per-coflow weight sums as a segment sum over the coflow ids (the
        # destination task instance), gathered back to the flows
        grp = (
            self.dst_t[None, :] * (self.N + 2) + self.delivered + 1
            + self.lag[None, :]
        )
        gsum = torch.zeros(self.B, self.n_groups, dtype=F64, device=w.device)
        gsum = gsum.scatter_add_(1, grp, w).gather(1, grp)
        w = w / gsum.clamp_min(EPS)
        r = w * self.ref_b[:, None]
        for _ in range(OMCOFLOW_ROUNDS):
            load = self.nic_sum(torch.where(mask, r, 0.0))
            s_in, s_out = self.per_flow(self.cap / load.clamp_min(EPS))
            r = r * torch.minimum(s_out, s_in).clamp_max(1.0)
        return torch.where(mask, r, 0.0)

    # ---- settle: fixpoint of same-instant completions/arms/starts ----
    def settle_round(self) -> torch.Tensor:
        t = self.t
        comp = self.running & (self.tend <= t[:, None] + EPS)
        done = self.done + comp
        running = self.running & ~comp
        tend = torch.where(comp, INF, self.tend)

        fin = self.active & (self.remaining <= self.thresh)
        delivered = self.delivered + fin
        remaining = torch.where(fin, 0.0, self.remaining)
        active = self.active & ~fin

        nxt = delivered + 1
        src_done = done.index_select(1, self.src_t)
        ready = (
            self.armable & ~active & (nxt <= self.last[None, :])
            & (src_done >= nxt)
        )
        vn = self.vol.gather(
            2, (nxt - 1).clamp(0, self.N - 1).unsqueeze(2)
        ).squeeze(2)
        if self.no_cascade:  # no zero-volume instance anywhere
            zero = None
            arm = ready
        else:
            zero = ready & (vn <= EPS)
            arm = ready & (vn > EPS)
            delivered = torch.where(zero, nxt, delivered)
        thresh = torch.where(arm, EPS * vn.clamp_min(1.0), self.thresh)
        remaining = torch.where(arm, vn, remaining)
        if self.policy == "fifo":  # only fifo's key reads release times
            self.release = torch.where(arm, t[:, None], self.release)
        active = active | arm

        ncand = done + 1
        need = ncand.index_select(1, self.dst_t) - self.lag[None, :]
        # an in-edge is violated when the instance it needs has not been
        # produced (local edge) or delivered (remote edge)
        violated = (need > 0) & torch.where(
            self.local, done.index_select(1, self.src_t) < need,
            delivered < need,
        )
        viol = violated.to(F64) @ self.in_adj
        dep = viol == 0.0
        can = ~running & (ncand <= self.N) & dep
        cidx = (ncand - 1).clamp(0, self.N - 1)
        exn = self.ex.gather(2, cidx.unsqueeze(2)).squeeze(2)
        end_new = t[:, None] + exn
        tend = torch.where(can, end_new, tend)
        running = running | can
        if self.record:
            sel = can[:, :, None] & (
                self.iter_ids[None, None, :] == cidx[:, :, None]
            )
            self.start_rec = torch.where(sel, t[:, None, None], self.start_rec)
            self.end_rec = torch.where(sel, end_new[:, :, None], self.end_rec)

        self.delivered, self.thresh, self.remaining = delivered, thresh, remaining
        self.active, self.done, self.running, self.tend = active, done, running, tend
        # another round is needed only for chained same-instant events:
        # zero-volume deliveries and zero-duration task starts
        if self.no_cascade:
            return torch.zeros((), dtype=torch.bool)
        return zero.any() | (can & (end_new <= t[:, None] + EPS)).any()

    def settle(self) -> None:
        changed = self.settle_round()
        while not self.no_cascade and bool(changed):
            changed = self.settle_round()

    # ---- advance: rate solve + next-event time + volume decrement ----
    def advance(self) -> None:
        # every rate rule returns 0 on inactive columns
        r = self.rates(self.active)
        t = self.t
        if self.E:
            dt = torch.where(
                r > EPS, self.remaining / r.clamp_min(EPS), INF
            )
            t_flow = t + dt.amin(1)
        else:
            t_flow = torch.full_like(t, INF)
        # tend is inf whenever a task is not running
        t_task = self.tend.amin(1)
        t_next = torch.minimum(t_task, t_flow)
        alive = self.alive()
        bad = alive & ~torch.isfinite(t_next)
        adv = alive & ~bad
        dtb = torch.where(adv, t_next - t, 0.0)
        self.remaining = self.remaining - r * dtb[:, None]
        self.t = torch.where(adv, t_next, t)
        self.nev = self.nev + adv
        self.stuck = self.stuck | bad
        # freeze deadlocked instances so the outer loop terminates
        self.active = self.active & ~bad[:, None]
        self.running = self.running & ~bad[:, None]

    def alive(self) -> torch.Tensor:
        return self.running.any(1) | self.active.any(1)

    def run(self, max_events: int) -> None:
        self.settle()
        k = 0
        while k < max_events and bool(self.alive().any()):
            # finished instances are frozen by advance (adv is false), so
            # running past the end of the last one changes nothing
            for _ in range(min(_CHECK_EVERY, max_events - k)):
                self.advance()
                self.settle()
                k += 1


def _task_events(start: np.ndarray, end: np.ndarray) -> List[TaskEvent]:
    """Recorded task starts ordered by (start, task, iteration), as the
    reference sorts them."""
    js, ns = np.nonzero(~np.isnan(start))
    st = start[js, ns]
    o = np.lexsort((ns, js, st))
    js, ns, st = js[o], ns[o], st[o]
    en = end[js, ns]
    return [
        TaskEvent(j, n + 1, s, e)
        for j, n, s, e in zip(js.tolist(), ns.tolist(), st.tolist(), en.tolist())
    ]


def _build_program(
    workload: Workload,
    cluster: ClusterSpec,
    ys: np.ndarray,
    realizations: Sequence[Realization],
    policy: str,
    record: bool,
    dev: torch.device,
) -> _Program:
    """The program for placements ``ys`` [B, J] and their realizations."""
    src_t, dst_t, lag = workload.edge_src, workload.edge_dst, workload.edge_lag
    vol = np.stack([r.volumes for r in realizations]).astype(np.float64)
    ex = np.stack([r.exec_times for r in realizations]).astype(np.float64)
    # statically rule out same-instant cascades: every edge instance
    # carries real volume and no task runs in zero time, so one settle
    # round is always a fixpoint
    no_cascade = bool(
        (workload.E == 0 or vol.min() > EPS) and float(ex.min()) > EPS
    )
    return _Program(
        dev=dev, policy=policy, record=record, no_cascade=no_cascade,
        vol=vol, ex=ex, src_m=ys[:, src_t], dst_m=ys[:, dst_t],
        src_t=src_t, dst_t=dst_t, lag=lag,
        bw_in=np.asarray(cluster.bw_in, dtype=np.float64),
        bw_out=np.asarray(cluster.bw_out, dtype=np.float64),
    )


def simulate_batch_torch(
    workload: Workload,
    cluster: ClusterSpec,
    placements: Sequence[Placement],
    realizations: Sequence[Realization],
    policy: str = "oes",
    record: bool = False,
    max_events: int = 50_000_000,
    *,
    device: DeviceLike = None,
) -> List[ScheduleResult]:
    """Run ``B = len(placements)`` independent jobs to completion in
    lock-step on ``device`` (default: the CUDA card); instance ``b`` pairs
    ``placements[b]`` with ``realizations[b]``.

    Same event semantics as the reference's ``simulate_batch`` on a
    static cluster without shaping or migrations; returns one
    ``ScheduleResult`` per instance agreeing with it at ``PARITY_RTOL``
    (see the module docstring).  ``record=True`` fills ``task_events``."""
    dev = resolve_device(device)
    name = policy_name(policy)
    B = len(placements)
    if B == 0:
        return []
    if len(realizations) != B:
        raise ValueError("placements and realizations must have equal length")
    N = realizations[0].n_iters
    if any(r.n_iters != N for r in realizations):
        raise ValueError("all realizations in a batch must share n_iters")
    J, M = workload.J, cluster.M
    ys = np.stack([np.asarray(p.y, dtype=np.int64) for p in placements])
    if ys.shape != (B, J) or ys.min() < 0 or ys.max() >= M:
        raise ValueError(
            f"placements must map each of the {J} tasks to a machine in "
            f"[0, {M})"
        )
    # no autograd bookkeeping: it only adds host time to every launch
    with torch.inference_mode():
        prog = _build_program(
            workload, cluster, ys, realizations, name, record, dev
        )
        prog.run(max_events)
        t = prog.t.cpu().numpy()
        nev = prog.nev.cpu().numpy()
        stuck = prog.stuck.cpu().numpy()
        alive = prog.alive().cpu().numpy()
    if stuck.any():
        raise RuntimeError("no progress: flows active but zero rates")
    if alive.any():
        raise RuntimeError("event limit exceeded — dependency deadlock?")
    if record:
        start_rec = prog.start_rec.cpu().numpy()
        end_rec = prog.end_rec.cpu().numpy()
    out: List[ScheduleResult] = []
    for b in range(B):
        events = _task_events(start_rec[b], end_rec[b]) if record else []
        out.append(
            ScheduleResult(
                makespan=float(t[b]),
                task_events=events,
                flow_log=None,
                n_events=int(nev[b]),
                policy=name,
            )
        )
    return out


def simulate_torch(
    workload: Workload,
    cluster: ClusterSpec,
    placement: Placement,
    realization: Realization,
    policy: str = "oes",
    record: bool = False,
    max_events: int = 50_000_000,
    *,
    device: DeviceLike = None,
) -> ScheduleResult:
    """One instance: ``simulate_batch_torch`` at width 1."""
    return simulate_batch_torch(
        workload, cluster, [placement], [realization], policy=policy,
        record=record, max_events=max_events, device=device,
    )[0]
