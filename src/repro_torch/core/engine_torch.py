"""The batched event engine as an eager PyTorch program.

The counterpart of the JAX package's ``repro.core.engine_jax``: one
lock-step event program over ``B`` independent (placement, realization)
instances, with the same event calculus as the numpy reference engine:

  * one outer iteration = one lock-step event per still-alive instance:
    a SETTLE fixpoint (task completions -> flow completions and migration
    gating -> flow arming incl. zero-volume cascades -> task starts,
    repeated until nothing changes at the current instant) followed by an
    ADVANCE step (rate solve, next-event time over task ends, flow
    drains, trace segment boundaries and deadline-escalation wakes,
    remaining-volume decrement, per-instance segment pointers);
  * all five built-in rate policies (oes / oes_strict / fifo / mrtf /
    omcoflow) are masked ``[B, EG]`` tensor programs over per-instance
    ``[B, M]`` NIC capacity rows, which each rule takes as an argument:
    the static cluster's, the current trace segment's, or what the
    shaping levels above left over.  The sequential waterfill of fifo and
    mrtf runs in ``repro_torch.kernels.waterfill``: a CUDA kernel on the
    card, its plain torch version on the CPU;
  * class shaping (``shaping="strict"`` / ``"deadline"``) is a loop over
    the run's class levels in ascending order (plus the escalation level
    in deadline mode), each rated by the base policy against the
    leftovers of the levels above, as in the JAX program.

The regimes, each off unless asked for: a ``BandwidthTrace`` (segment
rows and slowdowns, a segment pointer per instance), ``MigrationFlow``
columns ``E..E+G-1`` per instance (pre-armed at t=0, gating their task's
first iteration), class shaping with per-edge ``edge_classes``, and the
``utilization`` integrals.  Without them the program is the static one,
op for op.  Shaping ends, batch-wide, once no migration flow is in
flight and the training flows form one class: the base policy then rates
them alone, as the numpy engine does whenever one level is left.

Precision and parity: float64 throughout, agreeing with the numpy engine
on makespans, task-start schedules and flow logs at ``PARITY_RTOL`` /
``PARITY_ATOL`` (the JAX engine's contract).  Sums run in another order
than numpy's (scatter-add segment sums; on the card in atomic order), so
schedules can drift by a few ULPs per event.  By design, as in the JAX
engine, ``n_events`` counts lock-step iterations.  Unlike the JAX engine,
``record=True`` also fills ``flow_log``: arm and delivery times are
scattered into device buffers, read once at the end (``FlowLog`` builds
each instance's tuples at its first read).

Host synchronisation: PyTorch runs eagerly, so every loop condition the
JAX program evaluated on the device is a device-to-host copy here.  The
outer loop tests for termination every ``_CHECK_EVERY`` iterations
(``advance`` freezes finished instances, so the extra iterations change
nothing).  The oes progressive filling tests for an empty flow set after
every round (``_OES_CHECK_EVERY``), once per shaping level; whether the
shaping can end is tested with the termination check.  The settle
fixpoint stays exact: workloads that can cascade test for a change after
every settle round; the others settle in one.  Each choice was timed on
an H100 against its alternatives with ``engine_probe.py``; PERF.md has
the numbers.
"""
from __future__ import annotations

from functools import cached_property
from typing import TYPE_CHECKING, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .cluster import ClusterSpec, Placement
from .engine import (
    CLASS_TRAINING,
    EPS,
    OMCOFLOW_ROUNDS,
    DeviceLike,
    FlowLog,
    MigrationFlow,
    ScheduleResult,
    TaskEvent,
    check_edge_classes,
    check_migration_flows,
    escalated_level,
    policy_name,
    resolve_device,
    shaping_mode,
)
from .workload import Realization, Workload
from ..kernels.waterfill import waterfill_fill
from ..obs import metrics as obs_metrics

if TYPE_CHECKING:
    from numpy.typing import ArrayLike

    from ..dynamics.traces import BandwidthTrace

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


class _Caps:
    """The NIC capacity rows one rate pass runs against, ``cap`` [B, 2M]
    (column m is machine m's ingress, M + m its egress), and what they
    give each flow; each derived tensor is computed at its first use."""

    def __init__(self, prog: "_Program", cap: torch.Tensor) -> None:
        self.prog = prog
        self.cap = cap

    @cached_property
    def cap_in(self) -> torch.Tensor:
        return self.cap[:, : self.prog.M].contiguous()

    @cached_property
    def cap_out(self) -> torch.Tensor:
        return self.cap[:, self.prog.M :].contiguous()

    @cached_property
    def flow_caps(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Each flow's (ingress, egress) capacity."""
        return self.prog.per_flow(self.cap)

    @cached_property
    def lim(self) -> torch.Tensor:
        """The best rate each flow's two NICs allow, floored at EPS."""
        fd, fs = self.flow_caps
        return torch.minimum(fd, fs).clamp_min(EPS)

    @cached_property
    def ref_b(self) -> torch.Tensor:
        return torch.minimum(self.cap_in.amax(1), self.cap_out.amax(1))


class _Program:
    """The lock-step program for one batch: static tensors, the mutable
    state and the rate rules.  State tensors are rebound, never updated
    in place, so each step reads exactly the JAX program's values (the
    record buffers, written only, are the exception)."""

    def __init__(
        self,
        *,
        dev: torch.device,
        policy: str,
        record: bool,
        no_cascade: bool,
        vol: np.ndarray,  # [B, EG, N] f64
        ex: np.ndarray,  # [B, J, N] f64
        src_m: np.ndarray,  # [B, EG] machine per flow column
        dst_m: np.ndarray,  # [B, EG]
        local: np.ndarray,  # [B, EG] dependency only (or nothing to ship)
        src_t: np.ndarray,  # [E] task ids
        dst_t: np.ndarray,  # [E]
        lag: np.ndarray,  # [E]
        tr_times: np.ndarray,  # [S] segment starts (S == 1: static)
        tr_bw_in: np.ndarray,  # [S, M]
        tr_bw_out: np.ndarray,  # [S, M]
        tr_slow: Optional[np.ndarray] = None,  # [S, M]; None: no slowdowns
        ys: Optional[np.ndarray] = None,  # [B, J] task machines
        migs: Sequence[Sequence[MigrationFlow]] = (),  # per instance
        flow_cls: Optional[np.ndarray] = None,  # [B, EG]
        flow_dl: Optional[np.ndarray] = None,  # [B, EG]
        mode: Optional[str] = None,  # shaping
        utilization: bool = False,
    ) -> None:
        B, EG, N = vol.shape
        E = len(src_t)
        G = EG - E
        J = ex.shape[1]
        S, M = tr_bw_in.shape
        self.B, self.E, self.G, self.J, self.N, self.M, self.S = B, E, G, J, N, M, S
        self.policy = policy
        self.record = record
        self.no_cascade = no_cascade

        def on(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
            return torch.from_numpy(np.array(a, order="C")).to(dev, dtype)

        i64 = torch.int64
        z = dict(device=dev)
        self.vol = on(vol, F64)
        self.ex = on(ex, F64)
        self.src_mx = on(src_m, i64)
        self.dst_mx = on(dst_m, i64)
        # the waterfill kernel takes int32 machine ids
        self.src_mx32 = self.src_mx.to(torch.int32)
        self.dst_mx32 = self.dst_mx.to(torch.int32)
        local_t = on(local, torch.bool)
        self.local = local_t[:, :E]
        # training columns that ship their volume; migration columns are
        # armed once, at t=0, and never re-arm
        train = torch.arange(EG, device=dev) < E
        self.armable = ~local_t & train[None, :]
        self.src_t = on(src_t, i64)
        self.dst_t = on(dst_t, i64)
        self.lag = on(lag, i64)
        pad = np.zeros(G, dtype=np.int64)
        self.src_t_eg = on(np.concatenate([src_t, pad]), i64)
        # last instance of each column (0 for migration columns)
        self.last = on(np.concatenate([N - lag, pad]), i64)
        # static in-edge incidence: in_adj[e, j] = 1 iff edge e feeds task
        # j.  The dependency check counts violated in-edges with one
        # float64 matmul, exact for any count.
        in_adj = np.zeros((E, J), dtype=np.float64)
        in_adj[np.arange(E), dst_t] = 1.0
        self.in_adj = on(in_adj, F64)
        # omcoflow coflow ids: the destination task instance; each
        # migration column is a coflow of its own (task ids J + g)
        self.dst_t_grp = on(np.concatenate([dst_t, J + np.arange(G)]), i64)
        self.lag_grp = on(np.concatenate([lag, pad]), i64)
        self.n_groups = int((J + G) * (N + 2) + (lag.max() if E else 0) + 2)
        self.iter_ids = torch.arange(N, device=dev)
        # both NIC sides on one axis, so one scatter or gather serves both:
        # column m is machine m's ingress, column M + m its egress; flow e
        # uses ingress dst[e] and egress src[e]
        self.nic_idx = torch.cat([self.dst_mx, self.src_mx + M], 1)  # [B, 2EG]
        # capacity rows: one static row, or one per trace segment
        self.tr_cap = on(np.concatenate([tr_bw_in, tr_bw_out], 1), F64)  # [S, 2M]
        if S == 1:  # every instance sees the same rows all run long
            self.static_caps = _Caps(self, self.tr_cap.expand(B, 2 * M).contiguous())
        else:
            self.tr_times = on(tr_times, F64)
        self.tr_slow = None if tr_slow is None else on(tr_slow, F64)
        self.y_mat = None if ys is None else on(ys, i64)
        self.seg = torch.zeros(B, dtype=i64, **z)

        # shaping: the class levels in the order they are rated
        self.mode = mode
        self.dl_events = False
        if mode is not None:
            self.flow_cls = on(flow_cls, i64)
            self.flow_dl = on(flow_dl, F64)
            levels = tuple(int(c) for c in np.unique(flow_cls))
            self.dl_events = bool(mode == "deadline" and np.isfinite(flow_dl).any())
            if self.dl_events:
                self.top_level = escalated_level(levels)
                levels = (self.top_level,) + levels
                # flows that can escalate: background classes with a deadline
                self.escalable = self.flow_cls > CLASS_TRAINING
                self.dl_cand = self.escalable & torch.isfinite(self.flow_dl)
            self.levels = levels
        # Migration columns never re-arm, so once none is active in any
        # instance the training flows are all that is left: with one class
        # among them (below the escalation threshold in deadline mode) they
        # form one level, which the base policy rates alone, bit for bit,
        # as the numpy engine's one-level shortcut does.  ``run`` tests for
        # that with its termination check and then drops the shaping.
        train_cls = np.unique(flow_cls[:, :E]) if mode is not None else ()
        self.shaping_ends = bool(
            G and len(train_cls) == 1
            and (not self.dl_events or train_cls[0] <= CLASS_TRAINING)
        )

        self.t = torch.zeros(B, dtype=F64, **z)
        self.nev = torch.zeros(B, dtype=i64, **z)
        self.stuck = torch.zeros(B, dtype=torch.bool, **z)
        # migration columns start armed exactly like the numpy engine's:
        # local and zero-volume ones delivered at once, the rest active,
        # each gating its task's first iteration
        delivered0 = np.zeros((B, EG), dtype=np.int64)
        remaining0 = np.zeros((B, EG), dtype=np.float64)
        gate = np.full((B, max(G, 1)), J, dtype=np.int64)
        migleft0 = np.zeros((B, J), dtype=np.int64)
        for b, ms in enumerate(migs):
            for g, f in enumerate(ms):
                if local[b, E + g]:
                    delivered0[b, E + g] = 1
                    continue
                remaining0[b, E + g] = f.gb
                if f.task >= 0:
                    migleft0[b, f.task] += 1
                    gate[b, g] = f.task
        self.delivered = on(delivered0, i64)
        self.remaining = on(remaining0, F64)
        self.active = self.remaining > 0
        # completion threshold EPS*max(1, vol) of the in-flight instance
        self.thresh = torch.where(
            self.active, EPS * self.remaining.clamp_min(1.0), 0.0
        )
        self.release = torch.zeros(B, EG, dtype=F64, **z)
        if G:
            self.migleft = on(migleft0, i64)
            self.gate_idx = on(gate, i64)  # J: ungated or not a flow
        self.done = torch.zeros(B, J, dtype=i64, **z)
        self.running = torch.zeros(B, J, dtype=torch.bool, **z)
        self.tend = torch.full((B, J), INF, dtype=F64, **z)
        rec_shape = (B, J, N) if record else (1, 1, 1)
        self.start_rec = torch.full(rec_shape, float("nan"), dtype=F64, **z)
        self.end_rec = torch.full(rec_shape, float("nan"), dtype=F64, **z)
        if record:
            # the flow log: arm and delivery times of flow instance n of
            # column e at [b, e, n]; a column that records nothing in a
            # round writes its own spare slot [b, e, N] (one shared slot
            # would serialise B * EG stores on one address)
            self.arm_rec = torch.full((B, EG, N + 1), float("nan"), dtype=F64, **z)
            self.fin_rec = torch.full_like(self.arm_rec, float("nan"))
            self.record_flows(self.arm_rec, self.active, self.delivered, self.t)

        self.utilization = utilization
        if utilization:
            self.util = torch.zeros(B, 2 * M, dtype=F64, **z)  # GB per NIC
            self.busy = torch.zeros(B, M, dtype=F64, **z)
            self.agg_levels = tuple(int(c) for c in np.unique(flow_cls))
            self.cls_pos = on(np.searchsorted(self.agg_levels, flow_cls), i64)
            self.clsgb = torch.zeros(B, len(self.agg_levels), dtype=F64, **z)

        self.rates = {
            "oes": self.rates_oes,
            "oes_strict": self.rates_oes_strict,
            "fifo": self.rates_waterfill,
            "mrtf": self.rates_waterfill,
            "omcoflow": self.rates_omcoflow,
        }[policy]

    # ---- per-NIC segment sums and their per-flow gathers ----
    def nic_sum(self, vals: torch.Tensor) -> torch.Tensor:
        """[B, EG] per-flow values -> [B, 2M] sums per NIC (ingress, egress)."""
        v = vals.to(F64)
        out = torch.zeros(self.B, 2 * self.M, dtype=F64, device=v.device)
        return out.scatter_add_(1, self.nic_idx, torch.cat([v, v], 1))

    def per_flow(self, nic: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B, 2M] per-NIC values -> each flow's (ingress, egress) value."""
        g = nic.gather(1, self.nic_idx)
        EG = self.E + self.G
        return g[:, :EG], g[:, EG:]

    def record_flows(
        self, buf: torch.Tensor, mask: torch.Tensor, inst0: torch.Tensor,
        t: torch.Tensor,
    ) -> None:
        """Writes each instance's clock into ``buf`` at flow instance
        ``inst0`` (0-based) of every column where ``mask`` holds; no host
        sync."""
        idx = torch.where(mask, inst0, self.N).unsqueeze(2)
        buf.scatter_(2, idx, t[:, None, None].expand(idx.shape))

    # ---- rate policies: masked [B, EG] programs over [B, M] caps ----
    def rates_oes_strict(self, mask: torch.Tensor, caps: _Caps) -> torch.Tensor:
        d_in, d_out = self.per_flow(self.nic_sum(mask))
        fd, fs = caps.flow_caps
        r = torch.minimum(fd / d_in.clamp_min(1.0), fs / d_out.clamp_min(1.0))
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

    def rates_oes(self, mask: torch.Tensor, caps: _Caps) -> torch.Tensor:
        # lock-step progressive filling: at most 4*M rounds, ending early
        # once no instance has a flow left (tested every _OES_CHECK_EVERY
        # rounds), as in the JAX program
        live = torch.ones(self.B, dtype=torch.bool, device=mask.device)
        state = (torch.zeros_like(self.remaining), caps.cap, mask, live, mask)
        for i in range(4 * self.M):
            state = self.oes_round(*state)
            if (i + 1) % _OES_CHECK_EVERY == 0 and not bool(state[4].any()):
                break
        return torch.where(mask, state[0], 0.0)

    def rates_waterfill(self, mask: torch.Tensor, caps: _Caps) -> torch.Tensor:
        if self.policy == "fifo":
            key = torch.where(mask, self.release, INF)
        else:  # mrtf: remaining time at the best rate the caps allow
            key = torch.where(mask, self.remaining / caps.lim, INF)
        # stable, like jnp.argsort: flows armed at the same instant share
        # a fifo key and keep their column order
        order = torch.argsort(key, dim=1, stable=True)
        return waterfill_fill(
            order.to(torch.int32), self.src_mx32, self.dst_mx32, mask,
            caps.cap_in, caps.cap_out,
        )

    def rates_omcoflow(self, mask: torch.Tensor, caps: _Caps) -> torch.Tensor:
        pred = self.remaining.clamp_min(EPS) / caps.lim
        w = torch.where(mask, 1.0 / pred, 0.0)
        # per-coflow weight sums as a segment sum over the coflow ids (the
        # destination task instance), gathered back to the flows
        grp = (
            self.dst_t_grp[None, :] * (self.N + 2) + self.delivered + 1
            + self.lag_grp[None, :]
        )
        gsum = torch.zeros(self.B, self.n_groups, dtype=F64, device=w.device)
        gsum = gsum.scatter_add_(1, grp, w).gather(1, grp)
        w = w / gsum.clamp_min(EPS)
        r = w * caps.ref_b[:, None]
        for _ in range(OMCOFLOW_ROUNDS):
            load = self.nic_sum(torch.where(mask, r, 0.0))
            s_in, s_out = self.per_flow(caps.cap / load.clamp_min(EPS))
            r = r * torch.minimum(s_out, s_in).clamp_max(1.0)
        return torch.where(mask, r, 0.0)

    def compute_rates(self, caps: _Caps) -> torch.Tensor:
        """The rates of every active flow: the base policy against
        ``caps``, or under shaping one pass per class level, ascending,
        each against the capacity the levels above left over (a level
        absent from an instance leaves its rows untouched)."""
        if self.mode is None:
            return self.rates(self.active, caps)
        if self.dl_events:
            need = self.remaining / caps.lim
            urgent = self.escalable & ((self.flow_dl - self.t[:, None]) <= need)
            eff = torch.where(urgent, self.top_level, self.flow_cls)
        else:
            eff = self.flow_cls
        if len(self.levels) == 1:
            return self.rates(self.active, caps)
        r = torch.zeros_like(self.remaining)
        rem = caps
        for c in self.levels:
            m = self.active & (eff == c)
            sub = self.rates(m, rem)
            r = torch.where(m, sub, r)
            used = self.nic_sum(torch.where(m, sub, 0.0))
            rem = _Caps(self, (rem.cap - used).clamp_min(0.0))
        return r

    # ---- settle: fixpoint of same-instant completions/arms/starts ----
    def settle_round(self) -> torch.Tensor:
        t = self.t
        E = self.E
        comp = self.running & (self.tend <= t[:, None] + EPS)
        done = self.done + comp
        running = self.running & ~comp
        tend = torch.where(comp, INF, self.tend)

        fin = self.active & (self.remaining <= self.thresh)
        if self.record:  # the instance in flight is delivered + 1
            self.record_flows(self.fin_rec, fin, self.delivered, t)
        delivered = self.delivered + fin
        if self.G:  # a landed migration flow releases its gated task
            landed = torch.zeros(self.B, self.J + 1, dtype=torch.int64, device=t.device)
            landed.scatter_add_(1, self.gate_idx, fin[:, E:].to(torch.int64))
            self.migleft = self.migleft - landed[:, : self.J]
        remaining = torch.where(fin, 0.0, self.remaining)
        active = self.active & ~fin

        nxt = delivered + 1
        src_done = done.index_select(1, self.src_t_eg)
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
        if self.record:
            self.record_flows(self.arm_rec, arm, nxt - 1, t)
        active = active | arm

        ncand = done + 1
        need = ncand.index_select(1, self.dst_t) - self.lag[None, :]
        # an in-edge is violated when the instance it needs has not been
        # produced (local edge) or delivered (remote edge)
        violated = (need > 0) & torch.where(
            self.local, done.index_select(1, self.src_t) < need,
            delivered[:, :E] < need,
        )
        viol = violated.to(F64) @ self.in_adj
        dep = viol == 0.0
        can = ~running & (ncand <= self.N) & dep
        if self.G:  # a relocated task's first iteration waits for its state
            can = can & ~((ncand == 1) & (self.migleft > 0))
        cidx = (ncand - 1).clamp(0, self.N - 1)
        exn = self.ex.gather(2, cidx.unsqueeze(2)).squeeze(2)
        if self.tr_slow is not None:  # its machine's slowdown at start
            slow = self.tr_slow.index_select(0, self.seg).gather(1, self.y_mat)
            end_new = t[:, None] + exn * slow
        else:
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
    def caps_now(self) -> _Caps:
        if self.S == 1:
            return self.static_caps
        return _Caps(self, self.tr_cap.index_select(0, self.seg))

    def advance(self) -> None:
        caps = self.caps_now()
        # every rate rule returns 0 on inactive columns
        r = self.compute_rates(caps)
        t = self.t
        if self.E + self.G:
            dt = torch.where(
                r > EPS, self.remaining / r.clamp_min(EPS), INF
            )
            t_flow = t + dt.amin(1)
        else:
            t_flow = torch.full_like(t, INF)
        # tend is inf whenever a task is not running
        t_task = self.tend.amin(1)
        t_next = torch.minimum(t_task, t_flow)
        if self.S > 1:  # third event source: the next segment boundary
            nxt_seg = self.seg + 1
            t_break = torch.where(
                nxt_seg < self.S,
                self.tr_times[nxt_seg.clamp_max(self.S - 1)], INF,
            )
            t_next = torch.minimum(t_next, t_break)
        if self.dl_events:
            # fourth event source: the earliest possible escalation of a
            # still-background flow (errs early; the wake re-checks)
            esc = self.flow_dl - self.remaining / caps.lim
            cand = self.active & self.dl_cand & (esc > t[:, None] + EPS)
            t_next = torch.minimum(t_next, torch.where(cand, esc, INF).amin(1))
        alive = self.alive()
        bad = alive & ~torch.isfinite(t_next)
        adv = alive & ~bad
        dtb = torch.where(adv, t_next - t, 0.0)
        self.remaining = self.remaining - r * dtb[:, None]
        if self.utilization:
            # GB each flow moved this step, folded onto the NIC and class
            # axes; seconds with a task running, per machine
            dvol = r * dtb[:, None]
            self.util = self.util + self.nic_sum(dvol)
            nrun = torch.zeros(self.B, self.M, dtype=F64, device=t.device)
            nrun.scatter_add_(1, self.y_mat, self.running.to(F64))
            self.busy = self.busy + torch.where(nrun > 0, dtb[:, None], 0.0)
            self.clsgb = self.clsgb.scatter_add(1, self.cls_pos, dvol)
        self.t = torch.where(adv, t_next, t)
        if self.S > 1:
            new_seg = torch.searchsorted(self.tr_times, self.t, right=True) - 1
            self.seg = torch.where(
                adv, torch.maximum(self.seg, new_seg.clamp(0, self.S - 1)),
                self.seg,
            )
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
            if self.shaping_ends and not bool(self.active[:, self.E :].any()):
                self.mode, self.dl_events, self.shaping_ends = None, False, False
            # finished instances are frozen by advance (adv is false), so
            # running past the end of the last one changes nothing
            for _ in range(min(_CHECK_EVERY, max_events - k)):
                self.advance()
                self.settle()
                k += 1

    def flow_logs(self) -> List[FlowLog]:
        """Per instance, the recorded flows (``FlowLog``: tuples built at
        the first read)."""
        arm = self.arm_rec[:, :, : self.N].cpu().numpy()
        fin = self.fin_rec[:, :, : self.N].cpu().numpy()
        return [FlowLog(arm[b], fin[b]) for b in range(self.B)]


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
    *,
    trace: Optional["BandwidthTrace"] = None,
    migrations: Optional[Sequence[Optional[Sequence[MigrationFlow]]]] = None,
    shaping: Optional[str] = None,
    edge_classes: Optional["ArrayLike"] = None,
    utilization: bool = False,
) -> _Program:
    """The program for placements ``ys`` [B, J] and their realizations,
    under the regimes asked for (the JAX engine's host preparation)."""
    B = len(ys)
    J, E, M = workload.J, workload.E, cluster.M
    src_t, dst_t, lag = workload.edge_src, workload.edge_dst, workload.edge_lag
    vol = np.stack([r.volumes for r in realizations]).astype(np.float64)
    ex = np.stack([r.exec_times for r in realizations]).astype(np.float64)
    src_m, dst_m = ys[:, src_t], ys[:, dst_t]
    local = src_m == dst_m

    if migrations is not None and len(migrations) != B:
        raise ValueError("migrations must give one (possibly None) entry per instance")
    migs = [
        check_migration_flows(m, M, J)
        for m in (migrations if migrations is not None else [None] * B)
    ]
    G = max((len(m) for m in migs), default=0)
    flow_cls = np.zeros((B, E + G), dtype=np.int64)
    flow_dl = np.full((B, E + G), np.inf)
    ec = check_edge_classes(edge_classes, E)
    if ec is not None:
        flow_cls[:, :E] = ec
    if G:
        # columns E..E+G-1; an instance with fewer flows keeps inert
        # padding columns (local, zero volume) that never activate
        vol = np.concatenate([vol, np.zeros((B, G, vol.shape[2]))], axis=1)
        src_m = np.concatenate([src_m, np.zeros((B, G), dtype=np.int64)], axis=1)
        dst_m = np.concatenate([dst_m, np.zeros((B, G), dtype=np.int64)], axis=1)
        local = np.concatenate([local, np.ones((B, G), dtype=bool)], axis=1)
        for b, ms in enumerate(migs):
            for g, f in enumerate(ms):
                e = E + g
                src_m[b, e], dst_m[b, e] = f.src, f.dst
                vol[b, e, 0] = f.gb
                local[b, e] = (f.src == f.dst) or (f.gb <= EPS)
                flow_cls[b, e] = f.cls
                flow_dl[b, e] = f.deadline

    if trace is None:
        tr_times = np.zeros(1)
        tr_bw_in = np.asarray(cluster.bw_in, dtype=np.float64)[None, :]
        tr_bw_out = np.asarray(cluster.bw_out, dtype=np.float64)[None, :]
        tr_slow = None
    else:
        if trace.bw_in.shape[1] != M:
            raise ValueError(
                f"trace covers {trace.bw_in.shape[1]} machines but the "
                f"cluster has {M} — rebuild the trace after membership "
                "changes"
            )
        tr_times = np.asarray(trace.times, dtype=np.float64)
        tr_bw_in = np.asarray(trace.bw_in, dtype=np.float64)
        tr_bw_out = np.asarray(trace.bw_out, dtype=np.float64)
        tr_slow = np.asarray(trace.slow, dtype=np.float64)
        if np.all(tr_slow == 1.0):  # ex * 1.0 == ex: no slowdowns to apply
            tr_slow = None
    # statically rule out same-instant cascades: every training-edge
    # instance carries real volume and no (slowdown-scaled) task runs in
    # zero time, so one settle round is always a fixpoint (migration
    # columns never re-arm: their zero-volume and local cases are settled
    # at the start)
    min_slow = float(tr_slow.min()) if tr_slow is not None else 1.0
    no_cascade = bool(
        (E == 0 or vol[:, :E, :].min() > EPS) and float(ex.min()) * min_slow > EPS
    )
    return _Program(
        dev=dev, policy=policy, record=record, no_cascade=no_cascade,
        vol=vol, ex=ex, src_m=src_m, dst_m=dst_m, local=local,
        src_t=src_t, dst_t=dst_t, lag=lag,
        tr_times=tr_times, tr_bw_in=tr_bw_in, tr_bw_out=tr_bw_out,
        tr_slow=tr_slow,
        ys=ys if (tr_slow is not None or utilization) else None,
        migs=migs, flow_cls=flow_cls, flow_dl=flow_dl, mode=shaping,
        utilization=utilization,
    )


def simulate_batch_torch(
    workload: Workload,
    cluster: ClusterSpec,
    placements: Sequence[Placement],
    realizations: Sequence[Realization],
    policy: str = "oes",
    record: bool = False,
    max_events: int = 50_000_000,
    trace: Optional["BandwidthTrace"] = None,
    migrations: Optional[Sequence[Optional[Sequence[MigrationFlow]]]] = None,
    shaping: Optional[str] = None,
    edge_classes: Optional["ArrayLike"] = None,
    utilization: bool = False,
    *,
    device: DeviceLike = None,
) -> List[ScheduleResult]:
    """Run ``B = len(placements)`` independent jobs to completion in
    lock-step on ``device`` (default: the CUDA card); instance ``b`` pairs
    ``placements[b]`` with ``realizations[b]``.

    The reference's ``simulate_batch`` semantics, regimes included:
    ``trace`` (a ``BandwidthTrace`` over the cluster's machines; each
    instance walks its segments on its own clock), ``migrations`` (one
    entry per instance, ``None`` or a sequence of ``MigrationFlow``),
    ``shaping`` (``None``, ``"strict"`` or ``"deadline"``) with
    ``edge_classes`` ([E] class ids of the workload's edges), and
    ``utilization`` (fills ``ScheduleResult.aggregates``).  Returns one
    ``ScheduleResult`` per instance agreeing with the numpy engine at
    ``PARITY_RTOL`` (see the module docstring).  ``record=True`` fills
    ``task_events`` and ``flow_log``."""
    if obs_metrics.REGISTRY.enabled:
        # one pre-aggregated increment per call, outside the event loop
        obs_metrics.REGISTRY.counter("engine.simulate_batch.calls").inc()
        obs_metrics.REGISTRY.counter("engine.simulate_batch.instances").inc(
            len(placements)
        )
    return _simulate_batch(
        workload, cluster, placements, realizations, policy, record,
        max_events, trace, migrations, shaping, edge_classes, utilization,
        device,
    )


def _simulate_batch(
    workload: Workload,
    cluster: ClusterSpec,
    placements: Sequence[Placement],
    realizations: Sequence[Realization],
    policy: str,
    record: bool,
    max_events: int,
    trace: Optional["BandwidthTrace"],
    migrations: Optional[Sequence[Optional[Sequence[MigrationFlow]]]],
    shaping: Optional[str],
    edge_classes: Optional["ArrayLike"],
    utilization: bool,
    device: DeviceLike,
) -> List[ScheduleResult]:
    """``simulate_batch_torch``'s run, uncounted: ``simulate_torch``
    counts its own calls."""
    dev = resolve_device(device)
    name = policy_name(policy)
    mode = shaping_mode(shaping)
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
            workload, cluster, ys, realizations, name, record, dev,
            trace=trace, migrations=migrations, shaping=mode,
            edge_classes=edge_classes, utilization=utilization,
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
            flow_logs = prog.flow_logs()
        if utilization:
            util = prog.util.cpu().numpy()
            busy = prog.busy.cpu().numpy()
            clsgb = prog.clsgb.cpu().numpy()
    out: List[ScheduleResult] = []
    for b in range(B):
        agg = None
        if utilization:
            agg = {
                "nic_in_gb": util[b, :M].copy(),
                "nic_out_gb": util[b, M:].copy(),
                "busy_s": busy[b].copy(),
                "class_gb": {
                    lvl: float(clsgb[b, i]) for i, lvl in enumerate(prog.agg_levels)
                },
            }
        out.append(
            ScheduleResult(
                makespan=float(t[b]),
                task_events=_task_events(start_rec[b], end_rec[b]) if record else [],
                flow_log=flow_logs[b] if record else None,
                n_events=int(nev[b]),
                policy=name if mode is None else f"{name}+{mode}",
                aggregates=agg,
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
    trace: Optional["BandwidthTrace"] = None,
    migrations: Optional[Sequence[MigrationFlow]] = None,
    shaping: Optional[str] = None,
    edge_classes: Optional["ArrayLike"] = None,
    utilization: bool = False,
    *,
    device: DeviceLike = None,
) -> ScheduleResult:
    """One instance: ``simulate_batch_torch`` at width 1 (``migrations``
    is this instance's flow list), counted as ``engine.simulate.calls``
    as the reference counts its ``simulate``."""
    if obs_metrics.REGISTRY.enabled:
        obs_metrics.REGISTRY.counter("engine.simulate.calls").inc()
    return _simulate_batch(
        workload, cluster, [placement], [realization], policy, record,
        max_events, trace,
        [migrations] if migrations is not None else None,
        shaping, edge_classes, utilization, device,
    )[0]
