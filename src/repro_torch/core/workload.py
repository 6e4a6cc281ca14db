"""GNN training job -> task/flow DAG template (paper §III).

A copy of the JAX package's ``repro.core.workload``: the port imports
nothing of that package, so it keeps its own copy, with the same
arrays and the same numpy random streams.

A job has, per training iteration ``n``:

  store g  --(sampled node/edge features)-->  sampler s        (lag 0)
  sampler s --(mini-batch subgraphs)------->  its worker w     (lag 0)
  worker w  --(gradients)------------------>  every PS p       (lag 0)
  PS p      --(updated params)------------->  every worker w   (lag 1: used in n+1)

Execution dependencies (constraints (5)-(11)):
  * a task's iteration ``n`` needs all its in-edges' instances delivered
    (remote) or the source task's matching iteration done (local), plus its
    own iteration ``n-1`` done;
  * flow instances of the same logical edge transmit strictly in iteration
    order (constraint (11));
  * graph stores bootstrap at t=0 (constraint (5)).

The conclusion's AllReduce extension is implemented via
``sync="allreduce"``: instead of PS star flows we emit a bidirectional ring
(worker_i -> worker_{i+1}, lag 0 within an iteration for reduce-scatter and
lag-1 edges for the all-gather half), which OES schedules like any flows.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .units import GBArray, SecondsArray

from .cluster import PS, SAMPLER, STORE, WORKER, ClusterSpec, TaskSpec


@dataclass(frozen=True)
class Edge:
    """A logical flow template ``src -> dst`` with iteration lag.

    Instance ``n`` carries data produced by ``(src, n)`` and consumed by
    ``(dst, n + lag)``.  Instances exist for n in [1, N - lag].
    """

    src: int
    dst: int
    lag: int
    kind: str  # "g2s" | "s2w" | "w2p" | "p2w" | "ring"


@dataclass
class TrafficModel:
    """Per-iteration stochastic volumes/exec-times for one job.

    ``mean_volume[e]`` in GB, ``mean_exec[j]`` seconds; ``pmr`` scales a
    truncated-normal fluctuation so that max/mean across draws matches the
    paper's peak-to-mean ratio knob (Fig. 8/9). Only graph-data edges
    (g2s, s2w) fluctuate; tensor flows (w2p, p2w, ring) are deterministic
    as in the paper.
    """

    mean_volume: GBArray  # [E]
    mean_exec: SecondsArray  # [J]
    pmr: float = 1.16
    exec_jitter: float = 0.05
    fluctuating: Optional[np.ndarray] = None  # bool [E]

    def realize(self, n_iters: int, seed: int = 0) -> "Realization":
        rng = np.random.default_rng(seed)
        e, j = len(self.mean_volume), len(self.mean_exec)
        vol = np.tile(self.mean_volume[:, None], (1, n_iters))
        if self.pmr > 1.0 and self.fluctuating is not None and self.fluctuating.any():
            # Draw multiplicative factors in [2-pmr, pmr] (mean 1, peak pmr).
            lo = max(0.0, 2.0 - self.pmr)
            f = rng.uniform(lo, self.pmr, size=(int(self.fluctuating.sum()), n_iters))
            vol[self.fluctuating] *= f
        ex = np.tile(self.mean_exec[:, None], (1, n_iters))
        if self.exec_jitter > 0:
            ex *= rng.uniform(1 - self.exec_jitter, 1 + self.exec_jitter, size=(j, n_iters))
        return Realization(volumes=vol, exec_times=ex)


@dataclass
class Realization:
    """One concrete draw of per-iteration volumes [E, N] / exec times [J, N].

    Sharing a Realization across schedulers gives an apples-to-apples
    comparison (same 'online' arrival sequence for every policy)."""

    volumes: GBArray
    exec_times: SecondsArray

    @property
    def n_iters(self) -> int:
        return self.volumes.shape[1]

    def window(self, start: int, stop: Optional[int] = None) -> "Realization":
        """Iterations ``[start, stop)`` (0-based) as their own Realization.

        Interval-by-interval re-planning slices ONE realization of the full
        horizon so every strategy sees the same draws per interval
        regardless of where its re-plans land."""
        stop = self.n_iters if stop is None else stop
        if not 0 <= start < stop <= self.n_iters:
            raise ValueError(f"bad window [{start}, {stop}) for N={self.n_iters}")
        return Realization(
            volumes=self.volumes[:, start:stop].copy(),
            exec_times=self.exec_times[:, start:stop].copy(),
        )


@dataclass
class Workload:
    """Tasks + edges + traffic model for one training job.

    ``is_merged`` marks a workload produced by ``core.multijob``'s merge:
    its traffic model is NOT drawable directly (pmr/exec_jitter are maxed
    across the member jobs and shorter jobs need epsilon padding), so
    ``realize`` refuses and routes to ``realize_merged``."""

    tasks: List[TaskSpec]
    edges: List[Edge]
    traffic: TrafficModel
    n_iters: int
    sampler_of_worker: Dict[int, List[int]] = field(default_factory=dict)
    store_tasks: List[int] = field(default_factory=list)
    is_merged: bool = False

    def __post_init__(self) -> None:
        self.J = len(self.tasks)
        self.E = len(self.edges)
        self.edge_src = np.array([e.src for e in self.edges], dtype=np.int64)
        self.edge_dst = np.array([e.dst for e in self.edges], dtype=np.int64)
        self.edge_lag = np.array([e.lag for e in self.edges], dtype=np.int64)
        self.in_edges: List[List[int]] = [[] for _ in range(self.J)]
        self.out_edges: List[List[int]] = [[] for _ in range(self.J)]
        for i, e in enumerate(self.edges):
            self.in_edges[e.dst].append(i)
            self.out_edges[e.src].append(i)
        self.kinds = np.array([KIND_ID[t.kind] for t in self.tasks], dtype=np.int64)

    def realize(self, seed: int = 0, n_iters: Optional[int] = None) -> Realization:
        if self.is_merged:
            raise ValueError(
                "cannot realize a merged multi-job workload directly: "
                "pmr/exec_jitter are maxed across the member jobs and "
                "shorter jobs get no epsilon padding, so the draws would "
                "be silently wrong — use core.multijob.realize_merged "
                "(or merged_batch_cost for batched objectives) instead"
            )
        return self.traffic.realize(n_iters or self.n_iters, seed=seed)

    def task_names(self) -> List[str]:
        return [t.name for t in self.tasks]


KIND_ID = {STORE: 0, SAMPLER: 1, WORKER: 2, PS: 3}


# ---------------------------------------------------------------------------
# Job builders
# ---------------------------------------------------------------------------

def build_gnn_workload(
    *,
    n_stores: int,
    n_workers: int,
    samplers_per_worker: int,
    n_ps: int,
    n_iters: int,
    store_to_sampler_gb: float,
    sampler_to_worker_gb: float,
    grad_gb: float,
    store_exec_s: float,
    sampler_exec_s: float,
    worker_exec_s: float,
    ps_exec_s: float,
    pmr: float = 1.16,
    sync: str = "ps",
    demands: Optional[Dict[str, Dict[str, float]]] = None,
    store_skew: Optional[Sequence[float]] = None,
) -> Workload:
    """Build the paper's 4-kind task DAG.

    ``store_to_sampler_gb`` is the *total* graph data received by one sampler
    per iteration, split across stores proportionally to ``store_skew``
    (uniform by default — METIS partitions are size-balanced).
    ``grad_gb`` is the full model gradient size; each PS handles 1/n_ps of it.
    """
    demands = demands or DEFAULT_DEMANDS
    tasks: List[TaskSpec] = []
    store_ids, sampler_ids, worker_ids, ps_ids = [], [], [], []
    for g in range(n_stores):
        store_ids.append(len(tasks))
        tasks.append(TaskSpec(f"store{g}", STORE, demands[STORE]))
    sampler_of_worker: Dict[int, List[int]] = {}
    for w in range(n_workers):
        worker_ids.append(len(tasks))
        tasks.append(TaskSpec(f"worker{w}", WORKER, demands[WORKER]))
    for w in range(n_workers):
        mine = []
        for s in range(samplers_per_worker):
            mine.append(len(tasks))
            sampler_ids.append(len(tasks))
            tasks.append(TaskSpec(f"sampler{w}.{s}", SAMPLER, demands[SAMPLER]))
        sampler_of_worker[worker_ids[w]] = mine
    for p in range(n_ps):
        ps_ids.append(len(tasks))
        tasks.append(TaskSpec(f"ps{p}", PS, demands[PS]))

    skew = np.asarray(store_skew if store_skew is not None else np.ones(n_stores))
    skew = skew / skew.sum()

    edges: List[Edge] = []
    vols: List[float] = []
    fluct: List[bool] = []
    for s in sampler_ids:
        for gi, g in enumerate(store_ids):
            edges.append(Edge(g, s, 0, "g2s"))
            vols.append(store_to_sampler_gb * float(skew[gi]))
            fluct.append(True)
    for w, samplers in sampler_of_worker.items():
        for s in samplers:
            edges.append(Edge(s, w, 0, "s2w"))
            vols.append(sampler_to_worker_gb)
            fluct.append(True)
    if sync == "ps":
        for w in worker_ids:
            for p in ps_ids:
                edges.append(Edge(w, p, 0, "w2p"))
                vols.append(grad_gb / n_ps)
                fluct.append(False)
        for p in ps_ids:
            for w in worker_ids:
                edges.append(Edge(p, w, 1, "p2w"))
                vols.append(grad_gb / n_ps)
                fluct.append(False)
    elif sync == "allreduce":
        # Bidirectional ring among workers: reduce-scatter (lag 0 into the
        # pseudo-PS-free next iteration) modeled as 2 x (W-1) sequential-ish
        # shifts collapsed to neighbor edges carrying 2*(W-1)/W of grad each
        # (standard ring volume), consumed by the next iteration (lag 1).
        wn = len(worker_ids)
        per_link = 2.0 * (wn - 1) / max(wn, 1) * grad_gb / max(wn, 1)
        for i, w in enumerate(worker_ids):
            nxt = worker_ids[(i + 1) % wn]
            if w != nxt:
                edges.append(Edge(w, nxt, 1, "ring"))
                vols.append(per_link * wn / 2)  # aggregate both directions' steps
                fluct.append(False)
    else:  # pragma: no cover - config error
        raise ValueError(f"unknown sync mode {sync!r}")

    mean_exec = np.zeros(len(tasks))
    for g in store_ids:
        mean_exec[g] = store_exec_s
    for s in sampler_ids:
        mean_exec[s] = sampler_exec_s
    for w in worker_ids:
        mean_exec[w] = worker_exec_s
    for p in ps_ids:
        mean_exec[p] = ps_exec_s

    traffic = TrafficModel(
        mean_volume=np.array(vols, dtype=np.float64),
        mean_exec=mean_exec,
        pmr=pmr,
        fluctuating=np.array(fluct, dtype=bool),
    )
    return Workload(
        tasks=tasks,
        edges=edges,
        traffic=traffic,
        n_iters=n_iters,
        sampler_of_worker=sampler_of_worker,
        store_tasks=store_ids,
    )


DEFAULT_DEMANDS: Dict[str, Dict[str, float]] = {
    # Paper §VI-A: worker = 3 GB mem + 1 CPU + 1 GPU; sampler = 7 GB + 2 CPU;
    # PS = 5 GB + 1 CPU; store pinned per machine (counted since it occupies
    # memory for the partition + serving CPU).
    STORE: {"mem": 8.0, "cpu": 1.0},
    SAMPLER: {"mem": 7.0, "cpu": 2.0},
    WORKER: {"mem": 3.0, "cpu": 1.0, "gpu": 1.0},
    PS: {"mem": 5.0, "cpu": 1.0},
}
