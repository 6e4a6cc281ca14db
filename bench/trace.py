"""The traced steps: ``torch.profiler`` over a few steps in the window, read
into device rows, busy time, idle gaps and launch counts.

The profiler drops a trace's first device rows, more of them the longer
the process has run (the port's ``profiler_probe.py``; ROADMAP item 20).
As the port's ``chip_smoke.py::_traced`` does, every trace opens with
``spins`` spin kernels and the card synchronised; a trace counts only
where a spin kernel's row survives, and, besides, only where the rows of
each kernel family that is launched once a wrapper call (``one_per_launch``
of ``kernel_names.json``) number exactly what the wrapper's own launch
counter counted over the traced steps.  Otherwise the steps are traced
again with four times the spins, up to ``ATTEMPTS`` times; a trace that
still lost rows raises ``TraceLost`` and no split is reported from it.
"""
from __future__ import annotations

import bisect
import heapq
import importlib
import json
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

NAMES = json.loads((Path(__file__).resolve().parent / "kernel_names.json").read_text())
SPINS = 256
ATTEMPTS = 3
SPAN = "bench.traced_steps"


class TraceLost(RuntimeError):
    pass


def family_of(name: str) -> Optional[str]:
    """The port's kernel family a device row belongs to, or None."""
    key = name.lower()
    for fam, words in NAMES["families"].items():
        if any(w in key for w in words):
            return fam
    return None


def is_gemm(name: str) -> bool:
    key = name.lower()
    return family_of(name) is None and any(w in key for w in NAMES["gemm"])


def _counter(fam: str) -> int:
    module, fn, attr = NAMES["counters"][fam]
    mod = importlib.import_module(f"repro_torch.kernels.{module}")
    return int(getattr(getattr(mod, fn), attr))


def _launch_rows(rows: Dict[str, Tuple[int, float]], fam: str) -> int:
    words = NAMES["one_per_launch"][fam]
    return sum(n for name, (n, _) in rows.items() if any(w in name.lower() for w in words))


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _idle_gaps(busy: List[Tuple[float, float]], lo: float, hi: float,
               host: List[Tuple[float, float, str]]) -> Dict[str, float]:
    """Seconds of device idle time within [lo, hi] (in us), by what the host
    was doing at each gap's middle: the innermost host event (the one that
    started last among those running then), or "host idle"."""
    gaps, at = [], lo
    for a, b in busy:
        if a > at:
            gaps.append((at, min(a, hi)))
        at = max(at, b)
    if at < hi:
        gaps.append((at, hi))
    host = sorted(host)
    starts = [h[0] for h in host]
    out: Dict[str, float] = {}
    active: List[Tuple[float, float, str]] = []
    pushed = 0
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        upto = bisect.bisect_right(starts, mid)
        while pushed < upto:
            s, e, name = host[pushed]
            heapq.heappush(active, (-s, e, name))
            pushed += 1
        while active and active[0][1] <= mid:
            heapq.heappop(active)
        label = active[0][2] if active else "host idle"
        out[label] = out.get(label, 0.0) + (b - a) / 1e6
    return out


@dataclass
class Trace:
    """The device rows of ``steps`` traced steps: (count, seconds) by kernel
    name, the device's busy seconds and the traced wall, the idle gaps by
    the host's activity, the launches of each family the wrapper counters
    and the trace agreed on."""

    steps: int
    rows: Dict[str, Tuple[int, float]]
    busy_s: float
    window_s: float
    gaps: Dict[str, float]
    launches: Dict[str, int]

    def seconds(self, fam: Optional[str]) -> float:
        return sum(s for name, (_, s) in self.rows.items() if family_of(name) == fam)

    def gemm_seconds(self) -> float:
        return sum(s for name, (_, s) in self.rows.items() if is_gemm(name))

    def other_seconds(self) -> float:
        """Every row that is neither a library matrix product nor a kernel
        of the port's own (elementwise passes, reductions, copies, memsets)."""
        return sum(s for name, (_, s) in self.rows.items()
                   if family_of(name) is None and not is_gemm(name))

    def operations(self) -> int:
        return sum(n for n, _ in self.rows.values())

    def breakdown(self) -> Dict[str, List[List]]:
        ops = sorted(self.rows.items(), key=lambda kv: -kv[1][1])[:10]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[name[:160], s] for name, (_, s) in ops],
                "idle_gaps": [[name[:160], s] for name, s in gaps]}


def traced(run_steps: Callable[[int], None], steps: int) -> Trace:
    """Profile ``run_steps(steps)`` (which ends with the device idle) after
    the spin kernels, checking the trace as the module says."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    spins, why = SPINS, ""
    for attempt in range(ATTEMPTS):
        before = {fam: _counter(fam) for fam in NAMES["one_per_launch"]}
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(spins):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            with record_function(SPAN):
                run_steps(steps)
                torch.cuda.synchronize()
        counted = {fam: _counter(fam) - n for fam, n in before.items()}
        events = prof.events()
        dev = [e for e in events if e.device_type == DeviceType.CUDA]
        span = [e for e in events if e.device_type == DeviceType.CPU and e.name == SPAN]
        spin_kept = sum(1 for e in dev if NAMES["spin"] in e.name)
        # the device rows of operations: not the spins, and not the spans
        # the profiler mirrors onto the device's timeline
        work = [e for e in dev if NAMES["spin"] not in e.name
                and not getattr(e, "is_user_annotation", False)
                and not e.name.startswith("bench.")]
        rows: Dict[str, Tuple[int, float]] = {}
        for e in work:
            n, s = rows.get(e.name, (0, 0.0))
            rows[e.name] = (n + 1, s + (e.time_range.end - e.time_range.start) / 1e6)
        seen = {fam: _launch_rows(rows, fam) for fam in counted}
        if not span:
            why = "the traced span is missing"
        elif not spin_kept:
            why = f"none of {spins} spin kernels' rows kept"
        elif seen != counted:
            why = f"device rows a launch {seen} against the wrappers' counters {counted}"
        else:
            lo, hi = span[0].time_range.start, span[0].time_range.end
            busy = _union([(max(e.time_range.start, lo), min(e.time_range.end, hi))
                           for e in work if e.time_range.end > lo and e.time_range.start < hi])
            host = [(e.time_range.start, e.time_range.end, e.name) for e in events
                    if e.device_type == DeviceType.CPU and e.name != SPAN
                    and e.time_range.end > lo and e.time_range.start < hi]
            return Trace(steps, rows, sum(b - a for a, b in busy) / 1e6, (hi - lo) / 1e6,
                         _idle_gaps(busy, lo, hi, host), counted)
        print(f"[trace] attempt {attempt + 1}: {why}", file=sys.stderr,
              flush=True)
        spins *= 4
    raise TraceLost(f"the profiler lost rows in {ATTEMPTS} attempts: {why}")
