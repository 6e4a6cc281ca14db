"""Each device row and idle gap of the traced steps put down to one of the
port's own spans (``repro_torch/obs/spans.py``) and a phase.

From the profile that ``trace.traced`` takes (``attribute``):

- a device row shares its ``id`` (the CUDA correlation id) with the host
  runtime call that launched it (``cudaLaunchKernel``, ``cuLaunchKernelEx``,
  ``cudaMemcpyAsync``, ...), whose ``cpu_parent`` is the host operation
  (the ``kernels`` the profiler lists on host operations are matched by
  ids from two counters, and list some rows twice);
- that operation's ``cpu_parent`` chain is walked to the innermost name
  of ``span_names.json``;
- an autograd node on the way (``autograd::engine::evaluate_function:
  XBackward0``) is left for the forward operation with the node's forward
  thread and sequence number (the latest to start, which made the node):
  a block's backward takes its ``model.block`` (non-reentrant
  rematerialisation keeps the first forward's nodes), the head's backward
  ``model.head_loss``;
- an operation of another thread than the step's (the autograd engine's,
  on a card) with no span of its own takes the step's thread's innermost
  span open when it started (``train.backward``);
- a row under no span, or with no runtime call, is ``OUTSIDE``;
  rows under ``train.step`` alone stay ``train.step``'s: the spans and
  ``OUTSIDE`` partition the rows;
- each idle gap goes to the innermost span open on the host at its middle.

The phase of a row: ``backward`` through a node (or the fallback),
``recompute`` for ``model.block`` opened inside the backward, else the
phase of the train span it lies under (``span_names.json``), else
``other``.

``python3 -m bench.spans --workload <cell> --seed <n>``, from the root of
a checkout on a machine with a card, runs the cell's
program as ``bench/run.py`` does (its set-up and first steps, a few more
steps), traces ``trace_steps`` steps through ``trace.traced`` and prints
the cell's traced per-layer readings, the per-span readings
(``METRICS``), the ``[spans]`` line and each span's largest rows.
"""
from __future__ import annotations

import bisect
import json
import sys
from collections import defaultdict
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

from .trace import NAMES as KERNELS
from .trace import _idle_gaps, _union

NAMES = json.loads((Path(__file__).resolve().parent / "span_names.json").read_text())
SPANS = tuple(NAMES["spans"])
STEP, BLOCK = NAMES["step"], NAMES["block"]
NODE = NAMES["autograd_node"]
OUTSIDE = "outside"
PHASES = ("forward", "recompute", "backward", "optimizer", "other")
# per-layer metric -> (the spans it sums, "ms" or "ops"), each a traced step
METRICS = {
    "blocks_ms_per_step": ((BLOCK,), "ms"),
    "head_loss_ms_per_step": (("model.head_loss",), "ms"),
    "adamw_ms_per_step": (("train.adamw",), "ms"),
    "restack_ms_per_step": (("train.stack_grads", "train.write_weights"), "ms"),
    "blocks_ops_per_step": ((BLOCK,), "ops"),
    "adamw_ops_per_step": (("train.adamw",), "ops"),
}


def _cpu(e: Any) -> bool:
    return getattr(e.device_type, "name", str(e.device_type)) == "CPU"


def work_rows(events: Iterable[Any]) -> List[Any]:
    """The device rows ``trace.traced`` counts: not the spin kernels, not
    the spans the profiler mirrors onto the device."""
    return [e for e in events if getattr(e.device_type, "name", "") == "CUDA"
            and KERNELS["spin"] not in e.name and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("bench.")]


@dataclass
class Split:
    """The rows of ``steps`` traced steps by (label, phase) and name, a label
    a span of ``SPANS`` or ``OUTSIDE``; each span's host seconds (all its
    openings, every thread) and openings; idle seconds by label."""

    steps: int
    rows: Dict[Tuple[str, str], Dict[str, Tuple[int, float]]]
    host: Dict[str, float]
    opened: Dict[str, int]
    idle: Dict[str, float]

    def seconds(self, label: str, phase: Optional[str] = None) -> float:
        return sum(s for (lab, ph), names in self.rows.items()
                   if lab == label and phase in (None, ph) for _, s in names.values())

    def operations(self, label: str) -> int:
        return sum(n for (lab, _), names in self.rows.items() if lab == label
                   for n, _ in names.values())

    def total_seconds(self) -> float:
        return sum(s for names in self.rows.values() for _, s in names.values())

    def labels(self) -> List[str]:
        return [lab for lab in SPANS + (OUTSIDE,)
                if self.opened.get(lab) or self.operations(lab) or self.idle.get(lab)]

    def top(self, label: str, k: int = 5) -> List[Tuple[str, int, float]]:
        merged: Dict[str, Tuple[int, float]] = {}
        for (lab, _), names in self.rows.items():
            if lab == label:
                for name, (n, s) in names.items():
                    m = merged.get(name, (0, 0.0))
                    merged[name] = (m[0] + n, m[1] + s)
        return sorted(((name, n, s) for name, (n, s) in merged.items()), key=lambda r: -r[2])[:k]

    def where(self, row: str) -> Dict[str, float]:
        """The seconds of the rows named ``row`` by label."""
        out: Dict[str, float] = defaultdict(float)
        for (lab, _), names in self.rows.items():
            if row in names:
                out[lab] += names[row][1]
        return dict(out)

    def step_share(self) -> Optional[float]:
        """Of the device time under ``train.step``, the share under no span
        below it."""
        under = self.total_seconds() - self.seconds(OUTSIDE)
        return self.seconds(STEP) / under if under > 0 else None

    def line(self) -> str:
        ms = 1e3 / self.steps
        parts = []
        for lab in self.labels():
            by = ", ".join(f"{ph} {ms * self.seconds(lab, ph):.3f}" for ph in PHASES
                           if self.seconds(lab, ph))
            host = f", host {ms * self.host[lab]:.3f} ms" if lab in self.host else ""
            parts.append(f"{lab}: device {ms * self.seconds(lab):.3f} ms ({by or 'none'}), "
                         f"{self.operations(lab) / self.steps:g} ops{host}, idle "
                         f"{ms * self.idle.get(lab, 0.0):.3f} ms")
        share = self.step_share()
        if share is not None:
            parts.append(f"under {STEP} alone {100 * share:.3f}% of its device time")
        return "[spans] a traced step: " + "; ".join(parts)


def applications(config: Mapping[str, Any], traffic: Mapping[str, Any]) -> int:
    """``model.block``'s applications a step's forward: a layer each, and
    for zamba2 each application of the shared block."""
    n = config["n_layers"]
    if config["block_pattern"] == "zamba2":
        n += n // config["hybrid_every"]
    return n * traffic.get("accum_steps", 1)


def metric(split: Optional[Split], name: str, apps: int) -> Optional[float]:
    """``METRICS[name]`` a traced step; None without a split, where a span
    it reads was never opened, or where ``model.block`` was not opened
    twice (forward and recompute) for each of ``apps`` applications."""
    spans, unit = METRICS[name]
    if split is None or any(not split.opened.get(s) for s in spans):
        return None
    if split.opened.get(BLOCK, 0) != 2 * apps * split.steps:
        return None
    if unit == "ms":
        return 1e3 * sum(split.seconds(s) for s in spans) / split.steps
    return sum(split.operations(s) for s in spans) / split.steps


def _is_node(e: Any) -> bool:
    return e.name.startswith(NODE) or getattr(e, "scope", 0) == 1


def attribute(events: Sequence[Any], work: Sequence[Any], steps: int, lo: float,
              hi: float) -> Split:
    """The ``Split`` of the device rows ``work`` (``work_rows(events)``) of a
    profile's ``events``, the traced steps spanning [lo, hi] (us) on the
    host."""
    host = [e for e in events if _cpu(e)]
    spans = [e for e in host if e.name in SPANS
             and e.time_range.end > lo and e.time_range.start < hi]
    threads = [e.thread for e in spans if e.name == STEP]
    main = max(set(threads), key=threads.count) if threads else None
    on_main = sorted((e for e in spans if e.thread == main), key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in on_main]
    fwd: Dict[Tuple[int, int], Any] = {}
    for e in sorted(host, key=lambda e: e.time_range.start):
        if e.sequence_nr >= 0 and not _is_node(e):
            fwd[(e.thread, e.sequence_nr)] = e  # the latest to start made the node

    def innermost_on_main(t: float) -> Optional[Any]:
        best = None
        for e in on_main[:bisect.bisect_right(starts, t)]:
            if e.time_range.end > t:
                best = e
        return best

    def phase(span: Any, via_node: bool) -> str:
        if via_node:
            return "backward"
        e = span
        while e is not None:
            if _is_node(e):
                return "recompute" if span.name == BLOCK else "backward"
            if e.name in NAMES["phases"]:
                ph = NAMES["phases"][e.name]
                return "recompute" if span.name == BLOCK and ph == "backward" else ph
            e = e.cpu_parent
        return "other"

    memo: Dict[int, Tuple[str, str]] = {}

    def resolve(op: Any) -> Tuple[str, str]:
        e, via_node = op, False
        while e is not None:
            if e.name in SPANS:
                return e.name, phase(e, via_node)
            if _is_node(e):
                f = fwd.get((e.fwd_thread, e.sequence_nr)) if e.sequence_nr >= 0 else None
                if f is None:
                    break
                e, via_node = f, True
                continue
            e = e.cpu_parent
        if op.thread != main:
            span = innermost_on_main(op.time_range.start)
            if span is not None:
                return span.name, phase(span, False)
        return OUTSIDE, "other"

    calls = {e.id: e for e in host if e.name.startswith(NAMES["runtime_call"])}
    rows: Dict[Tuple[str, str], Dict[str, Tuple[int, float]]] = defaultdict(dict)
    for r in work:
        call = calls.get(r.id)
        op = call.cpu_parent if call is not None else None
        if op is None:
            key = (OUTSIDE, "other")
        else:
            if id(op) not in memo:
                memo[id(op)] = resolve(op)
            key = memo[id(op)]
        n, sec = rows[key].get(r.name, (0, 0.0))
        rows[key][r.name] = (n + 1, sec + (r.time_range.end - r.time_range.start) / 1e6)
    hosts: Dict[str, float] = defaultdict(float)
    opened: Dict[str, int] = defaultdict(int)
    for e in spans:
        hosts[e.name] += (e.time_range.end - e.time_range.start) / 1e6
        opened[e.name] += 1
    busy = _union([(max(r.time_range.start, lo), min(r.time_range.end, hi)) for r in work
                   if r.time_range.end > lo and r.time_range.start < hi])
    gaps = _idle_gaps(busy, lo, hi, [(e.time_range.start, e.time_range.end, e.name)
                                     for e in spans])
    idle = {OUTSIDE if lab == "host idle" else lab: s for lab, s in gaps.items()}
    return Split(steps, dict(rows), dict(hosts), dict(opened), idle)


def traced(run_steps, steps: int):
    """``trace.traced(run_steps, steps)`` and the ``Split`` of the profile it
    kept: (Trace, Split)."""
    from unittest import mock

    import torch

    from . import trace as trace_mod

    kept = []

    class Kept(torch.profiler.profile):
        def __exit__(self, *exc):
            out = super().__exit__(*exc)
            kept.append(self)
            return out

    with mock.patch.object(torch.profiler, "profile", Kept):
        tr = trace_mod.traced(run_steps, steps)
    events = kept[-1].events()
    span = [e for e in events if _cpu(e) and e.name == trace_mod.SPAN][0]
    work = work_rows(events)
    if len(work) != tr.operations():
        raise RuntimeError(f"{len(work)} rows against the trace's {tr.operations()}")
    return tr, attribute(events, work, steps, span.time_range.start, span.time_range.end)


def main(argv=None) -> int:
    import argparse
    import time

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--steps", type=int, default=8, help="unprofiled steps before the trace")
    ap.add_argument("--out", help="write the readings here as JSON")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    import torch

    from . import harness

    cell = harness.load_cell(args.workload, harness.ROOT)
    device = torch.device("cuda", 0)
    harness.build_kernels(cell.config, device)
    program = harness.Program(cell, args.seed, device)
    program.first_steps(cell.traffic["check_steps"])
    setup_s = time.perf_counter() - t_start
    walls, enqueues = [], []
    t0 = time.perf_counter()
    for _ in range(args.steps):
        _, enq, wall = program.step()
        walls.append(wall)
        enqueues.append(enq)
    window_s = time.perf_counter() - t0
    steps = cell.traffic["trace_steps"]
    tr, split = traced(lambda k: [program.step() for _ in range(k)], steps)
    tokens = args.steps * cell.traffic["batch"] * cell.traffic["seq"]
    run = harness.Run(cell.config, cell.traffic, setup_s, window_s, tokens, walls, enqueues,
                      0, tr)
    out: Dict[str, Any] = {m["name"]: harness.reader(m["name"]).read(run) for m in cell.per_layer}
    apps = applications(cell.config, cell.traffic)
    out.update({name: metric(split, name, apps) for name in METRICS})
    out["model_block_opened_per_step"] = split.opened.get(BLOCK, 0) / steps
    out["step_share_pct"] = 100 * split.step_share() if split.step_share() is not None else None
    out["span_rows_counted"] = sorted(set(tr.rows) & set(SPANS))
    spans = {lab: {"device_ms": {ph: 1e3 * split.seconds(lab, ph) / steps for ph in PHASES
                                 if split.seconds(lab, ph)},
                   "ops": split.operations(lab) / steps,
                   "host_ms": 1e3 * split.host.get(lab, 0.0) / steps,
                   "idle_ms": 1e3 * split.idle.get(lab, 0.0) / steps,
                   "top": [[name[:100], n / steps, 1e3 * s / steps]
                           for name, n, s in split.top(lab, 8)]}
             for lab in split.labels()}
    gemms = sorted(((s, name) for name, (_, s) in tr.rows.items()
                    if any(w in name.lower() for w in KERNELS["gemm"])), reverse=True)[:6]
    where = {name[:100]: {lab: 1e3 * s / steps for lab, s in split.where(name).items()}
             for _, name in gemms}
    print(split.line(), file=sys.stderr)
    for lab, rec in spans.items():
        for name, n, ms in rec["top"]:
            print(f"[spans] {lab} {ms:9.3f} ms {n:7g}x {name}", file=sys.stderr)
    print(json.dumps({"workload": cell.name, "seed": args.seed, "metrics": out,
                      "spans": spans, "largest_gemms": where}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"metrics": out, "spans": spans,
                                              "largest_gemms": where}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
