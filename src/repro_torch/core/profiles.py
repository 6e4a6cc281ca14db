"""Traffic/exec-time profiles for the paper's three datasets (Table II).

A copy of the JAX package's ``repro.core.profiles``: the port imports
nothing of that package, so it keeps its own copy, with the same
arrays and the same numpy random streams.

The paper drives both ETP's cost simulation and the §VI-B studies with
*profiled* per-iteration traffic volumes and task execution times collected
over 50 training iterations.  We have no testbed, so we derive the means
from first principles (dataset stats x sampling fan-outs x feature bytes)
and expose the same knobs the paper sweeps (per-sampler batch size, PMR).

Derivation of graph-data volume per sampler per iteration:
    nodes_per_seed  = 1 + f1 + f1*f2 + f1*f2*f3   (L=3 recursive sampling)
    unique_factor   = dedup from overlapping neighborhoods (denser graph
                      => more duplicates => smaller factor)
    bytes_per_node  = feature_len * 4 bytes (float32 features)
    volume_gb       = seeds_per_sampler * nodes_per_seed * unique_factor
                      * bytes_per_node / 2^30 (BYTES_PER_GB)
This reproduces the regime the paper reports (graph flows dominate tensor
flows by orders of magnitude; data transfer is the bottleneck).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional

import numpy as np

from .units import BYTES_PER_GB
from .workload import Workload, build_gnn_workload


@dataclass(frozen=True)
class DatasetProfile:
    name: str
    n_nodes: float
    n_edges: float
    feature_len: int
    fanout: tuple
    train_nodes: float
    unique_factor: float
    pmr: float
    # per-iteration exec-time means (seconds), calibrated to the paper's
    # hardware (GTX-1080Ti workers, 8-core-CPU samplers/stores)
    store_exec_s: float
    sampler_exec_s: float
    worker_exec_s: float
    ps_exec_s: float
    grad_gb: float

    def nodes_per_seed(self) -> float:
        total, width = 1.0, 1.0
        for f in self.fanout:
            width *= f
            total += width
        return total * self.unique_factor

    def sampler_volume_gb(self, seeds_per_sampler: int) -> float:
        bytes_per_node = self.feature_len * 4
        return seeds_per_sampler * self.nodes_per_seed() * bytes_per_node / BYTES_PER_GB


OGBN_PRODUCTS = DatasetProfile(
    name="ogbn-products",
    n_nodes=2.4e6,
    n_edges=61.8e6,
    feature_len=100,
    fanout=(5, 10, 15),
    train_nodes=196_615,
    unique_factor=0.80,
    pmr=1.16,  # paper §VI-B measured
    store_exec_s=0.040,
    sampler_exec_s=0.080,
    worker_exec_s=0.150,
    ps_exec_s=0.015,
    grad_gb=0.0013,  # GraphSAGE 3x256 (~0.33M params fp32) + optimizer msg
)

REDDIT = DatasetProfile(
    name="reddit",
    n_nodes=0.2e6,
    n_edges=114.6e6,
    feature_len=602,
    fanout=(5, 10, 25),
    train_nodes=153_431,
    unique_factor=0.70,  # dense graph: heavy neighborhood overlap
    pmr=1.16,
    store_exec_s=0.050,
    sampler_exec_s=0.110,
    worker_exec_s=0.260,
    ps_exec_s=0.015,
    grad_gb=0.0030,
)

OGBN_PAPERS100M = DatasetProfile(
    name="ogbn-papers100M",
    n_nodes=111e6,
    n_edges=1.6e9,
    feature_len=128,
    fanout=(12, 12, 12),
    train_nodes=1_207_179,
    unique_factor=0.85,  # sparse at this scale: few duplicates
    pmr=1.08,  # paper §VI-B measured
    store_exec_s=0.060,
    sampler_exec_s=0.120,
    worker_exec_s=0.200,
    ps_exec_s=0.020,
    grad_gb=0.0013,
)

PROFILES: Dict[str, DatasetProfile] = {
    p.name: p for p in (OGBN_PRODUCTS, REDDIT, OGBN_PAPERS100M)
}


def build_workload_from_profile(
    profile: DatasetProfile,
    *,
    n_stores: int,
    n_workers: int,
    samplers_per_worker: int,
    n_ps: int = 1,
    batch_size: int = 2000,
    n_epochs: Optional[float] = None,
    n_iters: Optional[int] = None,
    pmr: Optional[float] = None,
    sync: str = "ps",
) -> Workload:
    """Instantiate the paper's job on a dataset profile.

    ``batch_size`` is the per-worker mini-batch (2000 in the paper); the
    per-sampler seed count is batch_size / samplers_per_worker.  Iteration
    count follows the paper's epoch accounting: one epoch = every sampler
    passes over train_nodes / (batch * workers) iterations.
    """
    seeds_per_sampler = batch_size // samplers_per_worker
    vol_s = profile.sampler_volume_gb(seeds_per_sampler)
    if n_iters is None:
        if n_epochs is None:
            raise ValueError("give n_epochs or n_iters")
        per_epoch = max(1, round(profile.train_nodes / (batch_size * n_workers)))
        n_iters = max(1, int(round(per_epoch * n_epochs)))
    # worker/sampler exec scales ~linearly with per-worker batch vs the
    # 2000-seed calibration point
    scale = batch_size / 2000.0
    return build_gnn_workload(
        n_stores=n_stores,
        n_workers=n_workers,
        samplers_per_worker=samplers_per_worker,
        n_ps=n_ps,
        n_iters=n_iters,
        store_to_sampler_gb=vol_s,
        sampler_to_worker_gb=vol_s,  # subgraph + features forwarded on
        grad_gb=profile.grad_gb,
        store_exec_s=profile.store_exec_s * scale,
        sampler_exec_s=profile.sampler_exec_s * scale,
        worker_exec_s=profile.worker_exec_s * scale,
        ps_exec_s=profile.ps_exec_s,
        pmr=pmr if pmr is not None else profile.pmr,
        sync=sync,
    )
