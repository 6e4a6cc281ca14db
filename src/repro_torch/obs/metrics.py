"""Lightweight metrics registry: counters / gauges / histograms.

A copy of the JAX package's ``repro.obs.metrics`` (pure Python).  Off by
default, so that "off" costs nothing on the engine's hot path:

  * the registry is enabled by ``REPRO_OBS=1`` in the environment (read
    once at import) or programmatically via ``REGISTRY.enable()``;
  * while disabled, ``counter()`` / ``gauge()`` / ``histogram()`` hand
    back one shared no-op sentinel whose mutators are empty methods —
    call sites never branch, never allocate, never format strings;
  * instrumented code increments ONCE per call with pre-aggregated
    values, never per event inside the simulation loop.

This module imports nothing from the rest of ``repro_torch``, so every
layer can depend on it without import cycles.
"""
from __future__ import annotations

import math
import os
import threading
from typing import Any, Dict, List, Optional, Type, cast

_TRUTHY = ("1", "true", "yes", "on")


def _env_enabled() -> bool:
    return os.environ.get("REPRO_OBS", "").strip().lower() in _TRUTHY


class Counter:
    """Monotonically increasing count."""

    kind = "counter"

    def __init__(self, name: str) -> None:
        self.name = name
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += v

    def snapshot(self) -> dict:
        return {"kind": self.kind, "value": self.value}


class Gauge:
    """Last-written value."""

    kind = "gauge"

    def __init__(self, name: str) -> None:
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def snapshot(self) -> dict:
        return {"kind": self.kind, "value": self.value}


class Histogram:
    """Streaming summary (count/sum/min/max) plus a bounded sample tail."""

    kind = "histogram"
    MAX_SAMPLES = 256

    def __init__(self, name: str) -> None:
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.samples: List[float] = []

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if len(self.samples) < self.MAX_SAMPLES:
            self.samples.append(v)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def snapshot(self) -> dict:
        return {
            "kind": self.kind,
            "count": self.count,
            "sum": self.sum,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
            "mean": self.mean,
        }


class _Null:
    """Shared no-op metric handed out while the registry is disabled."""

    name = "<disabled>"
    kind = "null"
    value = 0.0
    count = 0
    sum = 0.0
    mean = 0.0

    def inc(self, v: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def snapshot(self) -> dict:  # pragma: no cover - never registered
        return {"kind": self.kind}


NULL = _Null()


class MetricsRegistry:
    def __init__(self, enabled: Optional[bool] = None) -> None:
        self.enabled = _env_enabled() if enabled is None else bool(enabled)
        self._metrics: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()

    def _get(self, name: str, cls: Type[Any]) -> Any:
        if not self.enabled:
            return NULL
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}"
                )
            return m

    def counter(self, name: str) -> Counter:
        # the disabled-path NULL sentinel duck-types every metric kind, so
        # the registry's typed accessors cast rather than narrow
        return cast(Counter, self._get(name, Counter))

    def gauge(self, name: str) -> Gauge:
        return cast(Gauge, self._get(name, Gauge))

    def histogram(self, name: str) -> Histogram:
        return cast(Histogram, self._get(name, Histogram))

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            return {k: m.snapshot() for k, m in sorted(self._metrics.items())}


#: Process-wide registry every layer of the port reports through.
REGISTRY = MetricsRegistry()


def enabled() -> bool:
    return REGISTRY.enabled
