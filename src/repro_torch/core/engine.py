"""Shared engine layer of the port: constants, result types, device choice
and the Monte-Carlo drivers every planner calls.

The event program itself lives in ``engine_torch`` (the counterpart of
the JAX package's ``engine_jax``).  What is here mirrors the parts of the
JAX package's ``repro.core.engine`` that the planner and the dynamics
tier need (traffic classes, shaping modes, migration flows), with
``device=`` in place of ``backend=``: there is one engine, and the
argument says where it runs.  ``device=None`` means the CUDA card; when
no card is present that raises, it never falls back to the CPU.  Tests
and CPU runs pass ``device="cpu"`` explicitly.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .cluster import ClusterSpec, Placement
from .units import GB, Seconds
from .workload import Realization, Workload

if TYPE_CHECKING:
    from numpy.typing import ArrayLike

EPS = 1e-9

# Traffic-class ids: LOWER id = HIGHER priority.  Training flows default
# to class 0 and migration flows to class 1; ``edge_classes`` may give a
# workload's own edges any integer class.
CLASS_TRAINING = 0
CLASS_MIGRATION = 1

# Class shaping (``shaping=``): classes are rated in ascending id order,
# each by the base policy against the capacity the classes above it left
# over.  ``deadline`` also escalates a background flow once its deadline
# slack is consumed (``escalated_level``).
SHAPING_MODES = ("strict", "deadline")

# The five built-in rate policies (the JAX package's engine.POLICIES):
# work-conserving OES, the paper's strict OES rule, FIFO (DistDGL), MRTF
# and the online-coflow baseline, which rescales its rates in
# OMCOFLOW_ROUNDS rounds.
POLICY_NAMES = ("oes", "oes_strict", "fifo", "mrtf", "omcoflow")
OMCOFLOW_ROUNDS = 4

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``None`` means ``"cuda"``.

    Raises ``RuntimeError`` when CUDA is asked for (explicitly or by
    default) and ``torch.cuda.is_available()`` is false — the port never
    moves a run to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}; expected cpu or cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested (the default) but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "on the CPU"
        )
    return dev


def policy_name(policy: str) -> str:
    """Checks that ``policy`` names a built-in rate policy."""
    if policy not in POLICY_NAMES:
        raise ValueError(
            f"the torch engine supports the built-in rate policies "
            f"{POLICY_NAMES}, got {policy!r} (class shaping is shaping=)"
        )
    return policy


def shaping_mode(shaping: Optional[str]) -> Optional[str]:
    """Checks that ``shaping`` is ``None`` or one of ``SHAPING_MODES``."""
    if shaping is not None and shaping not in SHAPING_MODES:
        raise ValueError(
            f"unknown shaping mode {shaping!r}; known: {SHAPING_MODES}"
        )
    return shaping


def escalated_level(levels: Sequence[int]) -> int:
    """The class a deadline-escalated flow is rated in: strictly above
    every class present and above training, ``min(classes,
    CLASS_TRAINING) - 1``.

    Under ``shaping="deadline"`` a background flow (class above
    ``CLASS_TRAINING``) escalates once the time left to its deadline no
    longer covers its remaining volume at the best rate its two NICs
    give it, ``deadline - now <= remaining / min(cap_in[dst],
    cap_out[src])``: earliest-deadline-first means the urgent transfer
    must outrank the very traffic that starves it.  A flow with no
    deadline (inf) never escalates, so deadline mode with no finite
    deadline is strict mode."""
    return min(min(levels), CLASS_TRAINING) - 1


def check_edge_classes(
    edge_classes: Optional["ArrayLike"], E: int
) -> Optional[np.ndarray]:
    """[E] int64 class ids of the workload's own edges, or ``None``."""
    if edge_classes is None:
        return None
    ec = np.asarray(edge_classes, dtype=np.int64)
    if ec.shape != (E,):
        raise ValueError(
            f"edge_classes must give one class id per logical edge "
            f"(expected shape ({E},), got {ec.shape})"
        )
    return ec


# ---------------------------------------------------------------------------
# Migration flows: one-shot state moves scheduled with the training traffic
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class MigrationFlow:
    """A one-shot state-relocation flow, released at t=0.

    ``src`` / ``dst`` are machine indices of the simulated cluster;
    ``gb`` is the state volume.  ``task`` optionally names the relocated
    task: that task may not start its first simulated iteration until
    this flow completes; ``-1`` leaves the flow ungated.  A flow whose
    ``src`` equals ``dst`` (or whose volume is ~0) ships nothing: it
    completes at once and never gates.

    ``cls`` is the flow's traffic class, read only under ``shaping=``;
    ``deadline`` is the absolute simulation time by which the flow should
    have landed so that it delays nothing (``inf``: never escalates)."""

    src: int
    dst: int
    gb: GB
    task: int = -1
    cls: int = CLASS_MIGRATION
    deadline: Seconds = float("inf")


def check_migration_flows(
    migrations: Optional[Sequence[MigrationFlow]], M: int, J: int
) -> List[MigrationFlow]:
    """Validates machine and task indices; returns the flows as a list.
    After a machine leaves, pre-leave machine indices must never meet the
    post-leave cluster, so an index outside it raises."""
    if not migrations:
        return []
    migs = list(migrations)
    for f in migs:
        if not (0 <= f.src < M and 0 <= f.dst < M):
            raise ValueError(
                f"migration flow {f} references a machine outside the "
                f"{M}-machine cluster — remap placements after membership "
                "changes before billing (stale pre-leave indices?)"
            )
        if f.task >= J:
            raise ValueError(
                f"migration flow {f} gates task {f.task} but the workload "
                f"has only {J} tasks"
            )
        if f.gb < 0:
            raise ValueError(f"migration flow {f} has negative volume")
        if np.isnan(f.deadline):
            raise ValueError(f"migration flow {f} has a NaN deadline")
    return migs


# ---------------------------------------------------------------------------
# Schedule recording
# ---------------------------------------------------------------------------
@dataclass
class TaskEvent:
    task: int
    iter: int
    start: Seconds
    end: Seconds


class FlowLog(Sequence[Tuple[int, int, float, float]]):
    """One instance's recorded flows: ``(edge, iter, start, end)`` tuples
    ordered by delivery time, then column, then iteration, as the numpy
    engine appends them.

    The engine hands over the arm and delivery times its run recorded
    (``[EG, N]`` each, NaN where nothing was delivered); the tuples are
    built at the first read.  A papers-sized batch records ~14M flow
    instances a run, and building every instance's tuples cost more host
    time than the run itself, while most callers read one log or none."""

    def __init__(self, arm: np.ndarray, fin: np.ndarray) -> None:
        self._times: Optional[Tuple[np.ndarray, np.ndarray]] = (arm, fin)
        self._rows: Optional[List[Tuple[int, int, float, float]]] = None
        self._len = int(np.count_nonzero(~np.isnan(fin)))

    def _built(self) -> List[Tuple[int, int, float, float]]:
        if self._rows is None:
            arm, fin = self._times
            es, ns = np.nonzero(~np.isnan(fin))
            end = fin[es, ns]
            o = np.argsort(end, kind="stable")
            es, ns, end = es[o], ns[o], end[o]
            self._rows = list(zip(
                es.tolist(), (ns + 1).tolist(), arm[es, ns].tolist(), end.tolist()
            ))
            self._times = None
        return self._rows

    def __len__(self) -> int:
        return self._len

    def __getitem__(self, i):  # type: ignore[override]
        return self._built()[i]

    def __iter__(self) -> Iterator[Tuple[int, int, float, float]]:
        return iter(self._built())

    def __eq__(self, other: object) -> bool:
        if isinstance(other, (FlowLog, list, tuple)):
            return self._built() == list(other)
        return NotImplemented

    def __repr__(self) -> str:
        return repr(self._built())


@dataclass
class ScheduleResult:
    """One simulated schedule.

    ``task_events`` and ``flow_log`` are filled when the run was recorded
    (``record=True``): ``flow_log`` (a ``FlowLog``) holds one ``(edge,
    iter, start, end)`` tuple per delivered flow instance, ``start`` its
    arm time, as the numpy reference engine records them (migration flows
    appear as columns ``E..E+G-1`` with iteration 1 and start 0.0).  It
    is ``None`` when the run was not recorded.  ``n_events`` counts lock-step
    iterations of the batched program (one iteration may retire several
    simultaneous events), so compare makespans, task-start matrices and
    flow logs across engines, never ``n_events``.  ``aggregates`` holds
    the ``utilization=True`` integrals: GB delivered into and out of each
    machine (``nic_in_gb``, ``nic_out_gb``), seconds each machine ran a
    task (``busy_s``) and GB delivered per traffic class (``class_gb``);
    ``None`` unless asked for."""

    makespan: Seconds
    task_events: List[TaskEvent]
    # (edge, iter, start, end) per delivered flow; None when unrecorded
    flow_log: Optional[Sequence[Tuple[int, int, float, float]]]
    n_events: int
    policy: str
    aggregates: Optional[dict] = None

    def task_start_matrix(self, J: int, N: int) -> np.ndarray:
        out = np.full((J, N), np.nan)
        for ev in self.task_events:
            out[ev.task, ev.iter - 1] = ev.start
        return out


# ---------------------------------------------------------------------------
# Monte-Carlo drivers
# ---------------------------------------------------------------------------
def monte_carlo_draws(
    workload: Workload, *, seed: int, n_iters: int, n_draws: int
) -> List[Realization]:
    """The canonical Monte-Carlo draw set for cost estimation: draw ``d``
    realizes at ``seed + 1000 * d``, the reference's stream, so the port's
    chains see the same draws as the reference's."""
    # the affine stream is the reference's canonical one, kept as it is so
    # that both packages draw identical volumes for one seed
    return [
        workload.realize(seed=seed + 1000 * d, n_iters=n_iters)  # repro-lint: disable=RL001
        for d in range(n_draws)
    ]


def expected_makespan(
    workload: Workload,
    cluster: ClusterSpec,
    placement: Placement,
    policy: str = "oes",
    n_iters: int = 20,
    n_draws: int = 3,
    seed: int = 0,
    device: DeviceLike = None,
) -> Seconds:
    """Monte-Carlo estimate of T'_Y (paper §V-B): simulate ``n_iters``
    iterations a few times with fresh draws from the traffic profile, all
    draws in one ``simulate_batch_torch`` call."""
    from .engine_torch import simulate_batch_torch

    reals = monte_carlo_draws(
        workload, seed=seed, n_iters=n_iters, n_draws=n_draws
    )
    results = simulate_batch_torch(
        workload, cluster, [placement] * n_draws, reals, policy=policy,
        device=device,
    )
    total = 0.0
    for r in results:
        total += r.makespan
    return total / n_draws


def mean_batch_makespans(
    workload: Workload,
    cluster: ClusterSpec,
    groups: Sequence[Tuple[Placement, Sequence[Realization]]],
    policy: str = "oes",
    device: DeviceLike = None,
) -> List[float]:
    """One ``simulate_batch_torch`` over ``(placement, realizations)``
    groups; returns each group's mean makespan over its realizations
    (summed in order, as the reference does).  ETP's pooled chain
    evaluation and ``expected_makespan_many`` go through here."""
    from .engine_torch import simulate_batch_torch

    batch_p: List[Placement] = []
    batch_r: List[Realization] = []
    sizes: List[int] = []
    for p, reals in groups:
        batch_p += [p] * len(reals)
        batch_r += list(reals)
        sizes.append(len(reals))
    results = simulate_batch_torch(
        workload, cluster, batch_p, batch_r, policy=policy, device=device
    )
    out: List[float] = []
    k = 0
    for s in sizes:
        total = 0.0
        for r in results[k : k + s]:
            total += r.makespan
        out.append(total / s)
        k += s
    return out


def expected_makespan_many(
    workload: Workload,
    cluster: ClusterSpec,
    placements: Sequence[Placement],
    policy: str = "oes",
    n_iters: int = 20,
    n_draws: int = 3,
    seed: int = 0,
    device: DeviceLike = None,
) -> List[float]:
    """T'_Y for many candidate placements sharing one draw seed: all
    placements x draws run in ONE ``simulate_batch_torch`` call."""
    if len(placements) == 0:
        return []
    reals = monte_carlo_draws(
        workload, seed=seed, n_iters=n_iters, n_draws=n_draws
    )
    return mean_batch_makespans(
        workload, cluster, [(p, reals) for p in placements], policy=policy,
        device=device,
    )
