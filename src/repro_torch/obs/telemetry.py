"""Planner-side telemetry: ETP search, replan decisions, cache hit rates.

A copy of the JAX package's ``repro.obs.telemetry`` over the port's
``ETPResult`` and ``ReplanRecord``.  Pure *read-side* helpers — they fold
the counters the planning stack already carries (``ETPResult``
evaluation/acceptance/cache counters, ``Replanner.records``, the global
metrics registry) into plain dicts for printing, JSON export or
benchmark rows.  Nothing here mutates planner
state, so telemetry can always be taken after the fact.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

from .metrics import REGISTRY


def search_telemetry(etp: Any) -> dict:
    """Per-search telemetry from an ``ETPResult``: objective trajectory,
    acceptance rate, memo-cache hit rate — plus per-chain stats when the
    search ran multi-chain (``ETPResult.chain_stats``)."""
    evals = int(etp.evaluations)
    hits = int(etp.cache_hits)
    proposals = int(getattr(etp, "proposals", 0))
    accepted = int(getattr(etp, "accepted", 0))
    out: Dict[str, Any] = {
        "best_makespan": float(etp.best_makespan),
        "evaluations": evals,
        "cache_hits": hits,
        "cache_hit_rate": hits / max(evals + hits, 1),
        "proposals": proposals,
        "accepted": accepted,
        "acceptance_rate": accepted / max(proposals, 1),
        "wall_time_s": float(etp.wall_time_s),
        "fallback": bool(etp.fallback),
        "objective_trajectory": [float(c) for c in etp.cost_trace],
    }
    chains = getattr(etp, "chain_stats", None)
    if chains:
        out["chains"] = chains
    return out


def replan_telemetry(records: Iterable[Any]) -> List[dict]:
    """One event dict per ``ReplanRecord`` (taken or declined)."""
    out: List[dict] = []
    for rec in records:
        row: Dict[str, Any] = {
            "trigger": rec.trigger,
            "replanned": bool(rec.replanned),
            "drift": float(rec.drift),
            "moved_tasks": int(rec.moved_tasks),
            "migration_gb": float(rec.migration_gb),
            "forced_gb": float(rec.forced_gb),
            "migration_s": float(rec.migration_s),
            "overlap_s": float(rec.overlap_s),
            "makespan": float(rec.makespan),
            "objective": float(rec.objective),
            "n_flows": len(rec.flows),
        }
        if rec.etp is not None:
            row["search"] = search_telemetry(rec.etp)
        out.append(row)
    return out


def cache_telemetry() -> Optional[dict]:
    """Feature-cache replay counters from the metrics registry (None when
    the registry is disabled or no replay has run)."""
    snap = REGISTRY.snapshot()
    acc = snap.get("cache.replay.accesses", {}).get("value", 0)
    hits = snap.get("cache.replay.hits", {}).get("value", 0)
    if not acc:
        return None
    return {
        "accesses": acc,
        "hits": hits,
        "hit_rate": hits / acc,
    }


def snapshot() -> Dict[str, dict]:
    """Everything the metrics registry has seen this process."""
    return REGISTRY.snapshot()
