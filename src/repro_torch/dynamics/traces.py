"""Time-varying cluster realizations: piecewise-constant bandwidth traces.

A copy of the JAX package's ``repro.dynamics.traces`` (same classes, same
numpy random streams: ``drift_trace(seed=s)`` gives the same arrays).  A
``BandwidthTrace`` describes, per machine, a piecewise-constant timeline
of

  * ingress / egress NIC bandwidth (GB/s), and
  * a compute-slowdown multiplier (>= 1 means the machine's tasks run
    that much slower — the straggler model),

which ``core.engine_torch.simulate_torch`` / ``simulate_batch_torch``
consume natively (``trace=``).  Within a segment everything is constant,
so the event engine stays exact: a segment boundary is one more event
source next to task completions and flow completions.

The planner-facing side (``repro_torch.dynamics.replan``) never sees the
future of a trace — it observes ``bw_at(t)`` snapshots, exactly what a
deployed monitor would report.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

from ..core.cluster import ClusterSpec
from ..core.units import GBpsArray, Ratio, Seconds, SecondsArray


@dataclass
class BandwidthTrace:
    """Piecewise-constant per-machine dynamics over one simulation.

    ``times[s]`` is the start of segment ``s`` (``times[0]`` must be 0);
    segment ``s`` spans ``[times[s], times[s+1])`` and the last one extends
    to infinity.  ``bw_in`` / ``bw_out`` are [S, M] GB/s, ``slow`` is
    [S, M] execution-time multipliers (1.0 = nominal, 2.0 = half speed).

    A trace whose final segment has zero bandwidth on a NIC that still has
    flows pending makes the simulation raise "no progress" — bandwidth may
    dip to zero mid-trace, but must recover before the work can finish.
    """

    times: SecondsArray  # [S]
    bw_in: GBpsArray  # [S, M]
    bw_out: GBpsArray  # [S, M]
    slow: Optional[np.ndarray] = None  # [S, M]; None -> all ones

    def __post_init__(self) -> None:
        self.times = np.asarray(self.times, dtype=np.float64)
        self.bw_in = np.asarray(self.bw_in, dtype=np.float64)
        self.bw_out = np.asarray(self.bw_out, dtype=np.float64)
        if self.slow is None:
            self.slow = np.ones_like(self.bw_in)
        self.slow = np.asarray(self.slow, dtype=np.float64)
        if self.times.ndim != 1 or len(self.times) != len(self.bw_in):
            raise ValueError("times and bw arrays must share the segment axis")
        if abs(float(self.times[0])) > 1e-12:
            raise ValueError("trace must start at t=0")
        if np.any(np.diff(self.times) <= 0):
            raise ValueError("segment times must be strictly increasing")
        if self.bw_in.shape != self.bw_out.shape or self.bw_in.shape != self.slow.shape:
            raise ValueError("bw_in / bw_out / slow shapes must match")
        if np.any(self.slow < 1.0 - 1e-12):
            raise ValueError("slowdown multipliers must be >= 1")

    @property
    def S(self) -> int:
        return len(self.times)

    @property
    def M(self) -> int:
        return self.bw_in.shape[1]

    def segment_at(self, t: Seconds) -> int:
        """Index of the segment containing time ``t``."""
        return int(np.searchsorted(self.times, t, side="right") - 1) if t > 0 else 0

    def bw_at(self, t: Seconds) -> Tuple[GBpsArray, GBpsArray]:
        """(bw_in[M], bw_out[M]) snapshot at time ``t`` — what a bandwidth
        monitor reports to the re-planner; no future segments leak."""
        s = self.segment_at(t)
        return self.bw_in[s].copy(), self.bw_out[s].copy()

    def snapshot_cluster(self, cluster: ClusterSpec, t: Seconds) -> ClusterSpec:
        """The cluster as the planner sees it at time ``t``: nominal
        capacities, current NIC bandwidths."""
        bw_in, bw_out = self.bw_at(t)
        return cluster.with_bandwidth(bw_in, bw_out)

    def window(self, t0: Seconds, t1: Optional[Seconds] = None) -> "BandwidthTrace":
        """Sub-trace covering [t0, t1), re-anchored so its own clock starts
        at 0 — the engine simulates each planning interval in local time."""
        s0 = self.segment_at(t0)
        keep = [s0]
        for s in range(s0 + 1, self.S):
            if t1 is not None and self.times[s] >= t1:
                break
            keep.append(s)
        times = np.maximum(self.times[keep] - t0, 0.0)
        return BandwidthTrace(
            times=times,
            bw_in=self.bw_in[keep].copy(),
            bw_out=self.bw_out[keep].copy(),
            slow=self.slow[keep].copy(),
        )


def constant_trace(cluster: ClusterSpec) -> BandwidthTrace:
    """The degenerate one-segment trace: simulating with it is equivalent
    to (though not an alias of) the static engine path."""
    return BandwidthTrace(
        times=np.zeros(1),
        bw_in=cluster.bw_in[None, :].copy(),
        bw_out=cluster.bw_out[None, :].copy(),
    )


@dataclass(frozen=True)
class DynamicsEvent:
    """One episode of non-nominal behaviour on one machine (or all).

    Over ``[t0, t1)`` machine ``machine`` (None = every machine) runs with
    its NIC bandwidths scaled by ``bw_scale`` and its task execution times
    multiplied by ``slowdown``.  Overlapping events compose
    multiplicatively — two half-bandwidth episodes give quarter bandwidth.
    ``t1=None`` means the episode persists to the end of the trace
    (a permanent shift, e.g. a re-negotiated link rate)."""

    t0: Seconds
    t1: Optional[Seconds] = None
    machine: Optional[int] = None
    bw_scale: float = 1.0
    slowdown: float = 1.0


def trace_from_events(
    cluster: ClusterSpec, events: Sequence[DynamicsEvent]
) -> BandwidthTrace:
    """Compile episodes into the piecewise-constant segment form."""
    cuts = {0.0}
    for ev in events:
        if ev.t0 < 0 or (ev.t1 is not None and ev.t1 <= ev.t0):
            raise ValueError(f"bad event interval [{ev.t0}, {ev.t1})")
        cuts.add(float(ev.t0))
        if ev.t1 is not None:
            cuts.add(float(ev.t1))
    times = np.array(sorted(cuts))
    S, M = len(times), cluster.M
    bw_scale = np.ones((S, M))
    slow = np.ones((S, M))
    for ev in events:
        seg = (times >= ev.t0) & (times < (ev.t1 if ev.t1 is not None else np.inf))
        rows = np.nonzero(seg)[0]
        cols = slice(None) if ev.machine is None else [ev.machine]
        for s in rows:
            bw_scale[s, cols] *= ev.bw_scale
            slow[s, cols] *= ev.slowdown
    return BandwidthTrace(
        times=times,
        bw_in=cluster.bw_in[None, :] * bw_scale,
        bw_out=cluster.bw_out[None, :] * bw_scale,
        slow=slow,
    )


def drift_trace(
    cluster: ClusterSpec,
    *,
    horizon_s: Seconds,
    n_segments: int = 6,
    seed: int = 0,
    bw_scale_range: Tuple[float, float] = (0.3, 1.0),
    drift_prob: float = 0.6,
    straggler_prob: float = 0.15,
    straggler_slowdown: float = 2.0,
) -> BandwidthTrace:
    """Random sustained-drift trace matching the measurement literature's
    picture: per segment, each machine independently keeps its previous
    bandwidth (prob ``1 - drift_prob``) or re-draws a scale factor from
    ``bw_scale_range``; with ``straggler_prob`` a machine additionally
    straggles (execution ``straggler_slowdown`` x) for that segment."""
    rng = np.random.default_rng(seed)
    times = np.linspace(0.0, horizon_s, n_segments, endpoint=False)
    M = cluster.M
    scale = np.ones((n_segments, M))
    slow = np.ones((n_segments, M))
    cur = np.ones(M)
    for s in range(n_segments):
        if s > 0:
            redraw = rng.random(M) < drift_prob
            draws = rng.uniform(*bw_scale_range, size=M)
            cur = np.where(redraw, draws, cur)
        scale[s] = cur
        slow[s] = np.where(
            rng.random(M) < straggler_prob, straggler_slowdown, 1.0
        )
    return BandwidthTrace(
        times=times,
        bw_in=cluster.bw_in[None, :] * scale,
        bw_out=cluster.bw_out[None, :] * scale,
        slow=slow,
    )


def relative_bw_drift(
    planned_bw_in: np.ndarray,
    planned_bw_out: np.ndarray,
    now_bw_in: np.ndarray,
    now_bw_out: np.ndarray,
) -> Ratio:
    """Largest per-machine relative NIC change since the incumbent plan —
    the quantity the re-planner thresholds on.

    The denominator is the LARGER of the planned and current bandwidth, so
    the measure lives in [0, 1]: dividing by the planned value alone
    explodes when a trace segment drives a NIC near zero at plan time (a
    recovery from ~0 to nominal would read as a ~1e9 "drift" and every
    subsequent wobble as another one — spurious re-plan storms).  For the
    common drop case (now <= planned) the value is unchanged."""
    denom_in = np.maximum(np.maximum(planned_bw_in, now_bw_in), 1e-9)
    denom_out = np.maximum(np.maximum(planned_bw_out, now_bw_out), 1e-9)
    rel_in = np.abs(now_bw_in - planned_bw_in) / denom_in
    rel_out = np.abs(now_bw_out - planned_bw_out) / denom_out
    return float(max(rel_in.max(), rel_out.max()))
