"""Observability for the port: metrics, schedule traces, blame, exporters.

Always available, off by default.  Three tiers, as in the JAX package's
``repro.obs``:

  * ``repro_torch.obs.metrics`` — process-wide counters/gauges/histograms,
    gated by ``REPRO_OBS=1`` (no-ops otherwise; the engine's event loop
    carries no obs code either way);
  * ``repro_torch.obs.trace`` / ``repro_torch.obs.blame`` — post-hoc
    analysis of a recorded schedule (``simulate_torch(..., record=True)``):
    task/flow spans, NIC utilization timelines, critical-path blame
    decomposition that conserves the makespan;
  * ``repro_torch.obs.perfetto`` / ``repro_torch.obs.telemetry`` —
    exporters: Chrome/Perfetto ``trace.json`` and planner telemetry dicts.

``metrics`` is imported eagerly (it has no intra-package dependencies and
the engine imports it); the analysis modules load lazily on first
attribute access so ``repro_torch.core -> repro_torch.obs.metrics`` never
cycles through ``repro_torch.obs.trace -> repro_torch.core``.  The
function ``blame`` shares its name with its module: importing the module
``repro_torch.obs.blame`` leaves ``repro_torch.obs.blame`` the function.
"""
from __future__ import annotations

import importlib
import sys
import types
from typing import Any

from .metrics import REGISTRY, MetricsRegistry, enabled  # noqa: F401

_LAZY = {
    "ScheduleTrace": ("trace", "ScheduleTrace"),
    "TaskSpan": ("trace", "TaskSpan"),
    "FlowSpan": ("trace", "FlowSpan"),
    "BlameReport": ("blame", "BlameReport"),
    "blame": ("blame", "blame"),
    "blame_by_tenant": ("blame", "blame_by_tenant"),
    "blame_delta": ("blame", "blame_delta"),
    "combine": ("blame", "combine"),
    "to_trace_events": ("perfetto", "to_trace_events"),
    "write_trace": ("perfetto", "write_trace"),
    "validate_trace_events": ("perfetto", "validate_trace_events"),
    "search_telemetry": ("telemetry", "search_telemetry"),
    "replan_telemetry": ("telemetry", "replan_telemetry"),
    "cache_telemetry": ("telemetry", "cache_telemetry"),
}

__all__ = ["REGISTRY", "MetricsRegistry", "enabled", *_LAZY]


def __getattr__(name: str) -> Any:
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    mod = importlib.import_module(f".{mod_name}", __name__)
    value = getattr(mod, attr)
    globals()[name] = value
    return value


class _Package(types.ModuleType):
    """This package's module type: the import system binds each imported
    submodule on its parent package, which would replace a lazy export
    of the same name (``blame``) by its module."""

    def __setattr__(self, name: str, value: Any) -> None:
        if isinstance(value, types.ModuleType) and _LAZY.get(name, (None,))[0] == name:
            return
        super().__setattr__(name, value)


sys.modules[__name__].__class__ = _Package
