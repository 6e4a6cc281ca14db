"""Placement audit quantities: the max degree Delta (eq. 20) and the
traffic summary.

A copy of ``one_iteration_degrees``, ``max_degree`` and
``traffic_summary`` from the JAX package's ``repro.core.analysis``.  The
Appendix-B chain lower bound follows a recorded per-flow log, which the
port's engine does not produce yet, so it is not here.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from .cluster import ClusterSpec, Placement
from .workload import Realization, Workload


def one_iteration_degrees(
    workload: Workload, placement: Placement, cluster: ClusterSpec
) -> Tuple[np.ndarray, np.ndarray]:
    """(Delta_in_hat[m], Delta_out_hat[m]) — counts of distinct inter-machine
    flow templates per machine in one iteration (includes the lag-1 PS->worker
    parameter flows, per the paper's F_one_iter definition)."""
    y = placement.y
    d_in = np.zeros(cluster.M, dtype=np.int64)
    d_out = np.zeros(cluster.M, dtype=np.int64)
    for e in range(workload.E):
        s, d = workload.edge_src[e], workload.edge_dst[e]
        if y[s] == y[d]:
            continue
        d_out[y[s]] += 1
        d_in[y[d]] += 1
    return d_in, d_out


def max_degree(
    workload: Workload, placement: Placement, cluster: ClusterSpec
) -> int:
    """Delta of eq. (20): the competitive ratio of OES."""
    d_in, d_out = one_iteration_degrees(workload, placement, cluster)
    return int(max(d_in.max(initial=0), d_out.max(initial=0)))


def traffic_summary(
    workload: Workload, placement: Placement, realization: Realization
) -> Dict[str, float]:
    """Total / inter-machine traffic (GB) under a placement — the quantity
    task placement minimizes first-order."""
    y = placement.y
    remote = y[workload.edge_src] != y[workload.edge_dst]
    total = float(realization.volumes.sum())
    cross = float(realization.volumes[remote].sum())
    return {
        "total_gb": total,
        "inter_machine_gb": cross,
        "locality_fraction": 1.0 - cross / max(total, 1e-12),
    }
