"""Multi-job planning (the paper's conclusion, last paragraph): several
GNN training jobs share one cluster; DGTP jointly searches placements for
all jobs and schedules every job's tasks and flows online on the shared
NICs.

A copy of the JAX package's ``repro.core.multijob`` on the torch engine:
the same merge, the same epsilon padding, the same namespaced seed
derivation and the same numpy random streams, with ``device=`` in place
of ``backend=`` on the simulating entry points (``merged_batch_cost``,
``joint_search``).

The jobs' task and flow sets are merged into one Workload (index
offsets; per-job iteration counts padded with epsilon work so the
engine's uniform-N loop is exact up to eps).  Everything downstream —
IFS/ETP, OES and the baselines, the Theorem-1 certificate — operates on
the merged job unchanged; Delta becomes the max NIC flow count across
all jobs, the quantity the shared-network guarantee should use.

Merged workloads are marked (``Workload.is_merged``): their traffic model
maxes pmr/exec_jitter across member jobs and shorter jobs need epsilon
padding, so ``Workload.realize`` refuses on them and routes to
``realize_merged`` here.

Seed derivation is namespaced (``derive_seed``, a splitmix64 mix): the
per-draw stream of ``merged_batch_cost`` and the per-job stream of
``realize_merged`` live in disjoint namespaces, so no (draw, job) cell can
share a realization seed with another.

``IncrementalMerge`` is the arrival-stream path: it memoizes per-job
fragments and realization draws keyed by a stable per-job token, so a
membership change pays only for the jobs it touches plus the assembly of
the engine's input arrays.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import (
    TYPE_CHECKING,
    Any,
    Callable,
    Dict,
    List,
    Optional,
    Sequence,
    Tuple,
)

import numpy as np

from .cluster import ClusterSpec, Placement, TaskSpec
from .engine import (
    DeviceLike,
    MigrationFlow,
    ScheduleResult,
    mean_batch_makespans,
)

if TYPE_CHECKING:  # placement imports this module at runtime, not vice versa
    from .placement import ETPResult
from .workload import Edge, Realization, TrafficModel, Workload

EPS_EXEC = 1e-6

# ---------------------------------------------------------------------------
# Namespaced seed derivation
# ---------------------------------------------------------------------------
_MASK64 = (1 << 64) - 1

#: disjoint namespaces for the derivation levels (arbitrary distinct
#: constants; what matters is that they differ)
SEED_NS_JOB = 0x6A6F62  # "job": per-job realization streams
SEED_NS_DRAW = 0x64726177  # "draw": per-draw merged realizations
SEED_NS_CHAIN = 0x636861696E  # "chain": per-chain ETP search streams


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    z = x
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & _MASK64


def derive_seed(base: int, namespace: int, index: int) -> int:
    """A child seed for ``(namespace, index)`` under ``base``.

    Distinct (namespace, index) pairs map to distinct streams with
    overwhelming probability (splitmix64 is a bijective mixer per input
    word), unlike affine offsets where two levels of derivation can land
    on the same integer.  Result fits in 63 bits."""
    h = _splitmix64((int(base) & _MASK64) ^ _splitmix64(((int(namespace) & _MASK64) << 20) ^ (int(index) & _MASK64)))
    return int(h & 0x7FFF_FFFF_FFFF_FFFF)


@dataclass
class MergedJob:
    workload: Workload
    task_offsets: List[int]  # job j's tasks start at task_offsets[j]
    n_iters: List[int]  # per-job true iteration counts
    # the member jobs (so draw-side helpers need no second argument) and
    # their stable seed tokens: realize_merged seeds job ji's stream from
    # job_seeds[ji] when present, else from the position ji.  Stable
    # tokens keep a job's draws fixed while OTHER jobs join/leave.
    jobs: Optional[List[Workload]] = None
    job_seeds: Optional[List[int]] = None
    names: Optional[List[str]] = None  # task-name tags, default str(ji)


def merge_workloads(
    jobs: Sequence[Workload],
    *,
    job_seeds: Optional[Sequence[int]] = None,
    names: Optional[Sequence[str]] = None,
) -> MergedJob:
    """Merge jobs into one Workload on a shared cluster.

    Graph stores keep their pinning semantics per job (store g of every
    job lives on machine g — multiple jobs share graph-store machines,
    as co-located deployments do)."""
    if names is None:
        names = [str(ji) for ji in range(len(jobs))]
    tasks: List[TaskSpec] = []
    edges: List[Edge] = []
    vols: List[float] = []
    fluct: List[bool] = []
    execs: List[float] = []
    offsets: List[int] = []
    n_max = max(j.n_iters for j in jobs)
    sampler_of_worker: Dict[int, List[int]] = {}
    store_tasks: List[int] = []
    for ji, job in enumerate(jobs):
        off = len(tasks)
        offsets.append(off)
        for t in job.tasks:
            tasks.append(TaskSpec(f"j{names[ji]}.{t.name}", t.kind, t.demand))
        for e in job.edges:
            edges.append(Edge(e.src + off, e.dst + off, e.lag, e.kind))
        vols.extend(job.traffic.mean_volume.tolist())
        fl = (
            job.traffic.fluctuating
            if job.traffic.fluctuating is not None
            else np.zeros(job.E, dtype=bool)
        )
        fluct.extend(fl.tolist())
        execs.extend(job.traffic.mean_exec.tolist())
        for w, ss in job.sampler_of_worker.items():
            sampler_of_worker[w + off] = [s + off for s in ss]
        store_tasks.extend(g + off for g in job.store_tasks)
    traffic = TrafficModel(
        mean_volume=np.asarray(vols),
        mean_exec=np.asarray(execs),
        pmr=max(j.traffic.pmr for j in jobs),
        exec_jitter=max(j.traffic.exec_jitter for j in jobs),
        fluctuating=np.asarray(fluct, dtype=bool),
    )
    merged = Workload(
        tasks=tasks,
        edges=edges,
        traffic=traffic,
        n_iters=n_max,
        sampler_of_worker=sampler_of_worker,
        store_tasks=store_tasks,
        is_merged=True,
    )
    return MergedJob(
        workload=merged,
        task_offsets=offsets,
        n_iters=[j.n_iters for j in jobs],
        jobs=list(jobs),
        job_seeds=list(job_seeds) if job_seeds is not None else None,
        names=list(names),
    )


def merge_migrations(
    mj: MergedJob, per_job: Sequence[Sequence[MigrationFlow]]
) -> List[MigrationFlow]:
    """Lift per-job migration flows onto the merged task index space.

    Under drift every co-located job re-plans on its own cadence; one
    merged simulation must carry EVERY job's pending state moves so the
    shared NICs arbitrate them against each other and against all jobs'
    training traffic.  Machine indices pass through unchanged (one shared
    cluster); gated task ids are shifted by the job's task offset, so
    ``per_job_makespans`` reports each job's completion with its own
    relocations honestly gated.  Ungated flows stay ungated."""
    if len(per_job) != len(mj.task_offsets):
        raise ValueError(
            f"per_job gives {len(per_job)} flow sets but the merged job "
            f"has {len(mj.task_offsets)} jobs"
        )
    out: List[MigrationFlow] = []
    for ji, flows in enumerate(per_job):
        off = mj.task_offsets[ji]
        for f in flows or ():
            out.append(
                MigrationFlow(
                    src=f.src, dst=f.dst, gb=f.gb,
                    task=f.task + off if f.task >= 0 else -1,
                    cls=f.cls, deadline=f.deadline,
                )
            )
    return out


def merged_edge_classes(
    mj: MergedJob, job_classes: Sequence[int]
) -> np.ndarray:
    """[E_merged] traffic-class ids: job ``ji``'s edges get
    ``job_classes[ji]``.  Feed the result to
    ``simulate_torch(..., edge_classes=..., shaping=...)`` to run a merged
    workload with per-job QoS classes — a latency-critical job's flows
    (lower class id) are then never contended by a batch job's traffic,
    while the batch job stays work-conserving on the leftover capacity.
    Edges are attributed to jobs via their source task's offset range, so
    the mapping survives any future reordering of the merge."""
    if len(job_classes) != len(mj.task_offsets):
        raise ValueError(
            f"job_classes gives {len(job_classes)} entries but the merged "
            f"job has {len(mj.task_offsets)} jobs"
        )
    bounds = np.asarray(mj.task_offsets + [mj.workload.J])
    job_of = np.searchsorted(bounds, mj.workload.edge_src, side="right") - 1
    return np.asarray(job_classes, dtype=np.int64)[job_of]


def _job_seed(seed: int, mj: MergedJob, ji: int) -> int:
    tok = mj.job_seeds[ji] if mj.job_seeds is not None else ji
    return derive_seed(seed, SEED_NS_JOB, tok)


def realize_merged(
    mj: MergedJob,
    jobs: Optional[Sequence[Workload]] = None,
    seed: int = 0,
    n_iters: Optional[int] = None,
) -> Realization:
    """Concatenate per-job realizations; shorter jobs get epsilon work
    beyond their true horizon (zero-volume flows deliver instantly,
    eps-exec tasks are effectively free — makespan error < J * N * eps).

    ``jobs`` defaults to the member jobs recorded on the MergedJob.
    ``n_iters`` caps the merged horizon (re-plan objectives score a short
    prefix); each job then realizes ``min(job.n_iters, n_iters)`` of its
    own stream.  Per-job seeds are namespaced via ``derive_seed`` on the
    job's stable token (``MergedJob.job_seeds``) when present."""
    jobs = list(jobs) if jobs is not None else mj.jobs
    if jobs is None:
        raise ValueError("realize_merged needs the member jobs (mj.jobs unset)")
    horizon = mj.workload.n_iters if n_iters is None else min(
        int(n_iters), mj.workload.n_iters
    )
    blocks = []
    for ji, job in enumerate(jobs):
        n_j = min(job.n_iters, horizon)
        blocks.append(job.realize(seed=_job_seed(seed, mj, ji), n_iters=n_j))
    return _pad_blocks(jobs, blocks, horizon)


def _pad_blocks(
    jobs: Sequence[Workload], blocks: Sequence[Realization], horizon: int
) -> Realization:
    """Assemble per-job realization blocks into the merged [E, horizon] /
    [J, horizon] arrays with epsilon padding beyond each job's block."""
    vol_parts, ex_parts = [], []
    for job, r in zip(jobs, blocks):
        n_j = r.n_iters
        vol = np.zeros((job.E, horizon))
        vol[:, :n_j] = r.volumes
        ex = np.full((job.J, horizon), EPS_EXEC)
        ex[:, :n_j] = r.exec_times
        vol_parts.append(vol)
        ex_parts.append(ex)
    return Realization(
        volumes=np.concatenate(vol_parts, axis=0),
        exec_times=np.concatenate(ex_parts, axis=0),
    )


def merged_batch_cost(
    mj: MergedJob,
    jobs: Optional[Sequence[Workload]] = None,
    cluster: Optional[ClusterSpec] = None,
    *,
    n_draws: int = 1,
    seed: int = 0,
    policy: str = "oes",
    device: DeviceLike = None,
) -> Callable[[Sequence[Placement]], List[float]]:
    """Batched merged-job objective for ETP: ``f(placements) -> makespans``.

    The merged workload's makespan cannot use ``Workload.realize`` (shorter
    jobs need the epsilon padding of ``realize_merged`` — and the merged
    workload refuses, see ``Workload.is_merged``), so the batch is sized
    here: every candidate placement is simulated against the same
    ``n_draws`` merged realizations in ONE ``simulate_batch_torch`` call on
    ``device`` — batch width = len(placements) x n_draws.  Draw ``d``
    realizes under ``derive_seed(seed, SEED_NS_DRAW, d)``, a namespace
    disjoint from the per-job streams inside each draw.  Plug into
    ``etp_multichain(batch_cost_fn=...)``."""
    reals = [
        realize_merged(mj, jobs, seed=derive_seed(seed, SEED_NS_DRAW, d))
        for d in range(n_draws)
    ]

    def cost(placements: Sequence[Placement]) -> List[float]:
        return mean_batch_makespans(
            mj.workload, cluster, [(p, reals) for p in placements],
            policy=policy, device=device,
        )

    return cost


def joint_search(
    jobs: Sequence[Workload],
    cluster: ClusterSpec,
    *,
    n_chains: int = 4,
    budget: int = 400,
    n_draws: int = 1,
    seed: int = 0,
    policy: str = "oes",
    device: DeviceLike = None,
    **kw: Any,
) -> Tuple[MergedJob, "ETPResult"]:
    """Joint multi-job DGTP placement search (paper conclusion): merge the
    jobs, then run lock-step multi-chain ETP where every chain's proposal is
    evaluated against shared-NIC merged realizations in one simulation
    batch.  Returns ``(MergedJob, ETPResult)``.  ``device`` is where the
    merged objective simulates (``None``: the CUDA card)."""
    from .placement import etp_multichain  # local import: placement imports engine

    mj = merge_workloads(jobs)
    cost = merged_batch_cost(
        mj, jobs, cluster, n_draws=n_draws, seed=seed, policy=policy,
        device=device,
    )
    etp = etp_multichain(
        mj.workload, cluster, n_chains=n_chains, budget=budget, seed=seed,
        batch_cost_fn=cost, **kw,
    )
    return mj, etp


# ---------------------------------------------------------------------------
# Per-job accounting
# ---------------------------------------------------------------------------
def _event_arrays(
    result: ScheduleResult,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    evs = result.task_events
    if not evs:
        raise ValueError(
            "result has no task events — per-job accounting needs a "
            "recorded run: simulate_torch(..., record=True) or "
            "simulate_batch_torch(..., record=True)"
        )
    n = len(evs)
    task = np.fromiter((ev.task for ev in evs), dtype=np.int64, count=n)
    it = np.fromiter((ev.iter for ev in evs), dtype=np.int64, count=n)
    end = np.fromiter((ev.end for ev in evs), dtype=np.float64, count=n)
    return task, it, end


def _job_of_tasks(mj: MergedJob, task: np.ndarray) -> np.ndarray:
    bounds = np.asarray(list(mj.task_offsets) + [mj.workload.J])
    return np.searchsorted(bounds, task, side="right") - 1


def per_job_makespans(mj: MergedJob, result: ScheduleResult) -> List[float]:
    """Completion time of each job's own last true iteration.

    Vectorized: events are attributed to jobs by ``np.searchsorted`` over
    the task-offset bounds and reduced with ``np.maximum.at``.
    Epsilon-padding iterations beyond a job's true horizon are
    excluded."""
    ends = np.zeros(len(mj.task_offsets))
    task, it, end = _event_arrays(result)
    job_of = _job_of_tasks(mj, task)
    mask = it <= np.asarray(mj.n_iters)[job_of]
    np.maximum.at(ends, job_of[mask], end[mask])
    return [float(e) for e in ends]


def per_job_iteration_ends(
    mj: MergedJob, result: ScheduleResult
) -> List[np.ndarray]:
    """Per job: array of length ``mj.n_iters[ji]`` giving the completion
    time of each TRUE iteration (max task-event end across the job's tasks
    at that iteration; 0.0 for iterations with no recorded event).  The
    arrival-stream driver uses this to count served iterations when an
    epoch is cut mid-flight and to read completion times."""
    counts = np.asarray(mj.n_iters, dtype=np.int64)
    base = np.concatenate([[0], np.cumsum(counts)])
    flat = np.zeros(int(base[-1]))
    task, it, end = _event_arrays(result)
    job_of = _job_of_tasks(mj, task)
    mask = it <= counts[job_of]
    idx = base[job_of[mask]] + (it[mask] - 1)
    np.maximum.at(flat, idx, end[mask])
    return [flat[base[ji]: base[ji + 1]] for ji in range(len(counts))]


# ---------------------------------------------------------------------------
# Incremental merge (arrival streams)
# ---------------------------------------------------------------------------
@dataclass
class _Fragment:
    """Membership-invariant pieces of one job's contribution to a merge."""

    job: Workload
    token: int
    tasks: List[TaskSpec]  # renamed once; names carry the job's own tag
    vols: np.ndarray
    execs: np.ndarray
    fluct: np.ndarray


class IncrementalMerge:
    """Incremental multi-job merge for arrival-driven streams.

    Calling ``merge_workloads`` + ``realize_merged`` on every membership
    change rebuilds every job's renamed task list and redraws + re-pads
    every job's realization to the global ``n_max`` horizon — over a
    stream of K joins/leaves that is O(K x active jobs x horizon) of pure
    re-derivation.  This class memoizes the membership-invariant pieces:

      * per-job fragments (renamed ``TaskSpec`` lists, traffic columns),
      * per-job realization draws keyed by ``(token, derived seed,
        horizon)`` — a surviving job's traffic never needs redrawing
        because its neighbours churned;

    and assigns each job a stable ``token`` at add time that seeds its
    realization stream (``MergedJob.job_seeds``), so draws are invariant
    to the job's POSITION in the merge.  ``merged()`` output is exactly
    ``merge_workloads(jobs, job_seeds=tokens, names=names)`` and
    ``realize()`` output exactly ``realize_merged`` at the same seeds,
    just cheaper along a stream.
    """

    def __init__(self) -> None:
        self._frags: Dict[str, _Fragment] = {}  # insertion-ordered
        self._next_token = 0
        self._reals: Dict[Tuple[int, int, int], Realization] = {}

    # -- membership -------------------------------------------------------
    def add_job(self, name: str, job: Workload) -> int:
        """Register ``job`` under ``name``; returns its stable seed token."""
        if name in self._frags:
            raise ValueError(f"job {name!r} already in the merge")
        if job.is_merged:
            raise ValueError("cannot add an already-merged workload as a job")
        token = self._next_token
        self._next_token += 1
        fl = (
            job.traffic.fluctuating
            if job.traffic.fluctuating is not None
            else np.zeros(job.E, dtype=bool)
        )
        self._frags[name] = _Fragment(
            job=job,
            token=token,
            tasks=[TaskSpec(f"j{name}.{t.name}", t.kind, t.demand) for t in job.tasks],
            vols=np.asarray(job.traffic.mean_volume, dtype=np.float64),
            execs=np.asarray(job.traffic.mean_exec, dtype=np.float64),
            fluct=np.asarray(fl, dtype=bool),
        )
        return token

    def remove_job(self, name: str) -> None:
        frag = self._frags.pop(name, None)
        if frag is None:
            raise KeyError(f"job {name!r} not in the merge")
        self._reals = {
            k: v for k, v in self._reals.items() if k[0] != frag.token
        }

    @property
    def names(self) -> List[str]:
        return list(self._frags)

    @property
    def n_jobs(self) -> int:
        return len(self._frags)

    def token(self, name: str) -> int:
        return self._frags[name].token

    def job(self, name: str) -> Workload:
        return self._frags[name].job

    # -- merge ------------------------------------------------------------
    def merged(self, n_iters: Optional[Dict[str, int]] = None) -> MergedJob:
        """Merge the current membership.  ``n_iters`` overrides per-job
        horizons (residual iteration counts for jobs cut mid-flight);
        omitted jobs keep their full horizon."""
        if not self._frags:
            raise ValueError("no jobs in the merge")
        n_iters = n_iters or {}
        names = list(self._frags)
        jobs: List[Workload] = []
        for name in names:
            frag = self._frags[name]
            r = int(n_iters.get(name, frag.job.n_iters))
            if not 1 <= r <= frag.job.n_iters:
                raise ValueError(
                    f"bad residual horizon {r} for job {name!r} "
                    f"(full horizon {frag.job.n_iters})"
                )
            jobs.append(
                frag.job
                if r == frag.job.n_iters
                else dataclasses.replace(frag.job, n_iters=r)
            )
        n_max = max(j.n_iters for j in jobs)
        tasks: List[TaskSpec] = []
        edges: List[Edge] = []
        offsets: List[int] = []
        sampler_of_worker: Dict[int, List[int]] = {}
        store_tasks: List[int] = []
        for name, job in zip(names, jobs):
            frag = self._frags[name]
            off = len(tasks)
            offsets.append(off)
            tasks.extend(frag.tasks)
            for e in job.edges:
                edges.append(Edge(e.src + off, e.dst + off, e.lag, e.kind))
            for w, ss in job.sampler_of_worker.items():
                sampler_of_worker[w + off] = [s + off for s in ss]
            store_tasks.extend(g + off for g in job.store_tasks)
        traffic = TrafficModel(
            mean_volume=np.concatenate([self._frags[n].vols for n in names])
            if names else np.zeros(0),
            mean_exec=np.concatenate([self._frags[n].execs for n in names]),
            pmr=max(j.traffic.pmr for j in jobs),
            exec_jitter=max(j.traffic.exec_jitter for j in jobs),
            fluctuating=np.concatenate([self._frags[n].fluct for n in names]),
        )
        merged = Workload(
            tasks=tasks,
            edges=edges,
            traffic=traffic,
            n_iters=n_max,
            sampler_of_worker=sampler_of_worker,
            store_tasks=store_tasks,
            is_merged=True,
        )
        return MergedJob(
            workload=merged,
            task_offsets=offsets,
            n_iters=[j.n_iters for j in jobs],
            jobs=jobs,
            job_seeds=[self._frags[n].token for n in names],
            names=names,
        )

    # -- realization ------------------------------------------------------
    def realize(
        self, mj: MergedJob, seed: int = 0, n_iters: Optional[int] = None
    ) -> Realization:
        """``realize_merged`` with per-job draw memoization: job blocks are
        keyed by (token, derived seed, horizon), so a membership change
        only redraws the jobs whose horizon or seed actually changed."""
        horizon = mj.workload.n_iters if n_iters is None else min(
            int(n_iters), mj.workload.n_iters
        )
        blocks = []
        for ji, job in enumerate(mj.jobs):
            n_j = min(job.n_iters, horizon)
            s = _job_seed(seed, mj, ji)
            key = (mj.job_seeds[ji], s, n_j)
            r = self._reals.get(key)
            if r is None:
                r = job.realize(seed=s, n_iters=n_j)
                self._reals[key] = r
            blocks.append(r)
        return _pad_blocks(mj.jobs, blocks, horizon)
