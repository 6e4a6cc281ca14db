"""Shared engine layer of the port: constants, result types, device choice
and the Monte-Carlo drivers every planner calls.

The event program itself lives in ``engine_torch`` (the counterpart of
the JAX package's ``engine_jax``).  What is here mirrors the parts of the
JAX package's ``repro.core.engine`` that the planner needs, with
``device=`` in place of ``backend=``: there is one engine, and the
argument says where it runs.  ``device=None`` means the CUDA card; when
no card is present that raises, it never falls back to the CPU.  Tests
and CPU runs pass ``device="cpu"`` explicitly.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .cluster import ClusterSpec, Placement
from .units import Seconds
from .workload import Realization, Workload

EPS = 1e-9

# Traffic-class ids: LOWER id = HIGHER priority.  Training flows are
# class 0; shaping by class comes to the port with ShapedPolicy.
CLASS_TRAINING = 0

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
            f"{POLICY_NAMES}, got {policy!r}"
        )
    return policy


# ---------------------------------------------------------------------------
# Schedule recording
# ---------------------------------------------------------------------------
@dataclass
class TaskEvent:
    task: int
    iter: int
    start: Seconds
    end: Seconds


@dataclass
class ScheduleResult:
    """One simulated schedule.

    ``flow_log`` is always ``None``: the torch engine, like the JAX one,
    never materialises per-flow spans.  ``n_events`` counts lock-step
    iterations of the batched program (one iteration may retire several
    simultaneous events), so compare makespans and task-start matrices
    across engines, never ``n_events``.  ``task_events`` is filled when
    the run was recorded (``record=True``)."""

    makespan: Seconds
    task_events: List[TaskEvent]
    flow_log: Optional[List[Tuple[int, int, float, float]]]
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
