"""Observability for the port: the metrics registry.

``repro_torch.obs.metrics`` is the JAX package's process-wide
counter/gauge/histogram registry, gated by ``REPRO_OBS=1``; the
re-planner counts into it.  Schedule traces, blame and the Perfetto
export are not ported yet (ROADMAP Queue 1 item 6).
"""
from .metrics import REGISTRY, MetricsRegistry, enabled  # noqa: F401

__all__ = ["REGISTRY", "MetricsRegistry", "enabled"]
