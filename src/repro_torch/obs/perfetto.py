"""Chrome/Perfetto trace-event export for ``ScheduleTrace``.

A copy of the JAX package's ``repro.obs.perfetto``.  Emits the JSON object format of the Trace Event spec (the one
ui.perfetto.dev and chrome://tracing both load):

  * one *process* per machine (pid = machine id, ``process_name``
    metadata from the cluster's machine names);
  * two *threads* per machine: ``tasks`` (tid 1) holding task-instance
    slices and ``flows in`` (tid 2) holding every flow delivering INTO
    the machine (training edges and migration pseudo-flows, with volume,
    class and edge id in ``args``);
  * per-machine NIC utilization counter tracks (``ph: "C"``), one sample
    per step of the trace's utilization timeline, in GB/s.

All slices are ``ph: "X"`` complete events with microsecond timestamps
(the spec's unit).  ``validate_trace_events`` structurally checks a
loaded trace against the spec (no external schema dependency) and is
what ``python -m repro_torch.obs.smoke`` runs on the exported file.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Union

from ..core.units import US_PER_SECOND as _US
from .trace import ScheduleTrace

_META_NAMES = (
    "process_name",
    "process_sort_index",
    "thread_name",
    "thread_sort_index",
)


def to_trace_events(tr: ScheduleTrace) -> dict:
    """Render a ``ScheduleTrace`` as a trace-event JSON object."""
    ev: List[dict] = []
    for m in range(tr.M):
        name = tr.machine_names[m] if m < len(tr.machine_names) else f"m{m}"
        ev.append(
            {
                "ph": "M",
                "pid": m,
                "tid": 0,
                "name": "process_name",
                "args": {"name": f"{name} (machine {m})"},
            }
        )
        ev.append(
            {
                "ph": "M",
                "pid": m,
                "tid": 1,
                "name": "thread_name",
                "args": {"name": "tasks"},
            }
        )
        ev.append(
            {
                "ph": "M",
                "pid": m,
                "tid": 2,
                "name": "thread_name",
                "args": {"name": "flows in"},
            }
        )
    for t in tr.tasks:
        ev.append(
            {
                "ph": "X",
                "pid": t.machine,
                "tid": 1,
                "name": f"{t.name}#{t.iter}",
                "cat": t.kind,
                "ts": t.start * _US,
                "dur": t.duration * _US,
                "args": {
                    "task": t.task,
                    "iter": t.iter,
                    "nominal_s": t.nominal_s,
                },
            }
        )
    for f in tr.flows:
        ev.append(
            {
                "ph": "X",
                "pid": f.dst,
                "tid": 2,
                "name": f"{f.name}#{f.iter}",
                "cat": "migration" if f.is_migration else "flow",
                "ts": f.start * _US,
                "dur": f.duration * _US,
                "args": {
                    "edge": f.edge,
                    "iter": f.iter,
                    "gb": f.gb,
                    "class": f.cls,
                    "src_machine": f.src,
                    "ideal_s": f.ideal_s,
                },
            }
        )
    for m in range(tr.M):
        for direction in ("in", "out"):
            times, rates = tr.utilization_timeline(m, direction)
            cname = f"nic_{direction}_gbps"
            for i, r in enumerate(rates):
                ev.append(
                    {
                        "ph": "C",
                        "pid": m,
                        "tid": 0,
                        "name": cname,
                        "ts": times[i] * _US,
                        "args": {cname: float(r)},
                    }
                )
            # close the final step so the counter drops to its last value
            ev.append(
                {
                    "ph": "C",
                    "pid": m,
                    "tid": 0,
                    "name": cname,
                    "ts": times[-1] * _US,
                    "args": {cname: float(rates[-1])},
                }
            )
    return {
        "traceEvents": ev,
        "displayTimeUnit": "ms",
        "otherData": {
            "policy": tr.policy,
            "shaping": tr.shaping or "none",
            "makespan_s": tr.makespan,
        },
    }


def write_trace(tr: ScheduleTrace, path: Union[str, "os.PathLike[str]"]) -> dict:
    """Export ``tr`` to ``path`` as Perfetto-loadable JSON; returns the
    rendered object (already validated)."""
    obj = to_trace_events(tr)
    validate_trace_events(obj)
    with open(path, "w") as fh:
        json.dump(obj, fh)
    return obj


def validate_trace_events(obj: object) -> Dict[str, int]:
    """Structural validation against the trace-event JSON spec.

    Checks the invariants Perfetto's importer relies on (object format,
    per-phase required fields, numeric non-negative timestamps/durations,
    metadata names drawn from the spec's set).  Raises ``ValueError`` on
    the first violation; returns per-phase event counts on success.
    """
    if not isinstance(obj, dict):
        raise ValueError(f"trace must be a JSON object, got {type(obj).__name__}")
    events = obj.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError("trace object must carry a 'traceEvents' list")
    counts: Dict[str, int] = {}
    for i, e in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(e, dict):
            raise ValueError(f"{where}: event must be an object")
        ph = e.get("ph")
        if ph not in ("X", "C", "M"):
            raise ValueError(f"{where}: unsupported phase {ph!r}")
        if not isinstance(e.get("pid"), int):
            raise ValueError(f"{where}: pid must be an integer")
        if not isinstance(e.get("name"), str) or not e["name"]:
            raise ValueError(f"{where}: name must be a non-empty string")
        if ph in ("X", "C"):
            ts = e.get("ts")
            if not isinstance(ts, (int, float)) or ts < 0:
                raise ValueError(f"{where}: ts must be a non-negative number")
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"{where}: dur must be a non-negative number")
        if ph == "C":
            args = e.get("args")
            if not isinstance(args, dict) or not args:
                raise ValueError(f"{where}: counter needs a non-empty args dict")
            for k, v in args.items():
                if not isinstance(v, (int, float)):
                    raise ValueError(
                        f"{where}: counter series {k!r} must be numeric"
                    )
        if ph == "M":
            if e["name"] not in _META_NAMES:
                raise ValueError(
                    f"{where}: metadata name {e['name']!r} not in {_META_NAMES}"
                )
            if not isinstance(e.get("args"), dict):
                raise ValueError(f"{where}: metadata needs an args dict")
        counts[ph] = counts.get(ph, 0) + 1
    return counts
