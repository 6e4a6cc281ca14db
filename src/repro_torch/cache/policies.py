"""Cache policies: trace replay -> per-iteration hit fractions.

Three families, mirroring the literature the subsystem is modeled on:

  * ``static``  — hotness-based static tiering (Data Tiering, arXiv
    2111.05894): the cache is prefilled with the top-C nodes by measured
    touch frequency (degree ordering is the deployable proxy; the replay
    uses trace hotness, its idealisation) and never changes.  Hit rate is
    flat across iterations and insensitive to who shares the cache.
  * ``lru``     — demand-filled least-recently-used: cold at iteration 1,
    warms as the working set cycles back.  Colocated samplers *compound*:
    a node pulled for one sampler is a hit for every other sampler on the
    machine, so the shared cache's hit rate grows with the sharing degree
    (until capacity pressure from the union working set bites).
  * ``prefetch`` — deterministic-sampling prefetch (RapidGNN, arXiv
    2509.05207): seeds and fan-outs are pseudo-random, so iteration n+1's
    support set is computable at iteration n and can be fetched off the
    critical path.  Everything that fits in the prefetch buffer is a hit
    from iteration 2 on; iteration 1 is inherently cold.

Every replay returns hits/accesses *per iteration* for one cache serving a
group of samplers — the unit the volume-rewriting layer (adjust.py)
consumes.  All three replays are stack/fraction algorithms, so hit rates
are monotone non-decreasing in capacity (property-tested).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, List

import numpy as np

from ..obs import metrics as obs_metrics
from .trace import AccessTrace


def _group_streams(trace: AccessTrace, k: int) -> List[List[np.ndarray]]:
    if k < 1:
        raise ValueError("sharing degree k must be >= 1")
    return trace.merged(k)


def replay_static(
    trace: AccessTrace, capacity_nodes: int, k: int = 1
) -> np.ndarray:
    """[N] hit fraction per iteration for a prefilled top-C hotness cache."""
    streams = _group_streams(trace, k)
    if capacity_nodes <= 0:
        return np.zeros(len(streams))
    hot = trace.touch_counts(k)
    cached = np.zeros(trace.n_nodes, dtype=bool)
    top = np.argsort(hot, kind="stable")[::-1][:capacity_nodes]
    cached[top] = True
    out = np.zeros(len(streams))
    for n, per_sampler in enumerate(streams):
        acc = hits = 0
        for arr in per_sampler:
            acc += len(arr)
            hits += int(cached[arr].sum())
        out[n] = hits / max(acc, 1)
    return out


def replay_lru(trace: AccessTrace, capacity_nodes: int, k: int = 1) -> np.ndarray:
    """[N] hit fraction per iteration for one shared LRU cache.

    The k samplers' per-iteration access sets interleave in sampler order
    (the iteration barrier makes finer interleavings indistinguishable at
    this granularity).  LRU is a stack algorithm: a larger cache's resident
    set always contains a smaller one's, so hits are monotone in capacity.
    """
    streams = _group_streams(trace, k)
    out = np.zeros(len(streams))
    if capacity_nodes <= 0:
        return out
    lru: "OrderedDict[int, None]" = OrderedDict()
    for n, per_sampler in enumerate(streams):
        acc = hits = 0
        for arr in per_sampler:
            acc += len(arr)
            for v in arr.tolist():
                if v in lru:
                    hits += 1
                    lru.move_to_end(v)
                else:
                    lru[v] = None
                    if len(lru) > capacity_nodes:
                        lru.popitem(last=False)
        out[n] = hits / max(acc, 1)
    return out


def replay_prefetch(
    trace: AccessTrace, capacity_nodes: int, k: int = 1
) -> np.ndarray:
    """[N] hit fraction per iteration under deterministic-sampling prefetch.

    With sampling deterministic given the seed stream, iteration n's union
    support set is known one iteration ahead; whatever fits in the buffer
    is resident before the iteration starts.  Iteration 1 has nothing to
    prefetch behind and is fully cold."""
    streams = _group_streams(trace, k)
    out = np.zeros(len(streams))
    if capacity_nodes <= 0:
        return out
    for n, per_sampler in enumerate(streams[1:], start=1):
        union = np.unique(np.concatenate(per_sampler))
        covered = min(1.0, capacity_nodes / max(len(union), 1))
        # every sampler's accesses hit at the union coverage rate (the
        # buffer stores one copy per node, shared across the group)
        out[n] = covered
    return out


REPLAYS: Dict[str, Callable[[AccessTrace, int, int], np.ndarray]] = {
    "static": replay_static,
    "lru": replay_lru,
    "prefetch": replay_prefetch,
}


def replay(
    trace: AccessTrace, policy: str, capacity_nodes: int, k: int = 1
) -> np.ndarray:
    """Dispatch to a policy replay; [N] per-iteration hit fractions."""
    try:
        fn = REPLAYS[policy]
    except KeyError:
        raise ValueError(
            f"unknown cache policy {policy!r}; known: {sorted(REPLAYS)}"
        ) from None
    out = fn(trace, int(capacity_nodes), k)
    if obs_metrics.REGISTRY.enabled:
        # aggregate hit-rate counters (REPRO_OBS=1): weight each
        # iteration's hit fraction by its access count so the registry's
        # hits/accesses ratio reproduces the true pooled hit rate
        accesses = np.array(
            [sum(len(a) for a in per) for per in trace.merged(k)],
            dtype=np.float64,
        )
        obs_metrics.REGISTRY.counter("cache.replay.calls").inc()
        obs_metrics.REGISTRY.counter("cache.replay.accesses").inc(
            float(accesses.sum())
        )
        obs_metrics.REGISTRY.counter("cache.replay.hits").inc(
            float((out * accesses).sum())
        )
    return out
