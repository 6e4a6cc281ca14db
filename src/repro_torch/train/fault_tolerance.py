"""Fault tolerance and elasticity for long multi-machine runs.

A copy of the JAX package's ``repro.train.fault_tolerance`` over the
port's ``Replanner`` and ``etp_search``; every re-plan's simulations run
on the controller's ``device`` (``None``: the CUDA card).

  * checkpoint/restart — ``train/checkpoint.py`` (atomic manifest-last
    publish; restore is exact);
  * failure handling — ``FailureController`` wraps the training loop:
    on a (simulated or real) host failure it (1) restores the latest
    checkpoint, (2) re-plans task placement on the surviving machines via
    ``repro_torch.dynamics.replan.Replanner.on_leave`` (warm-started ETP
    whose migration bill is SIMULATED: candidate moves and the dead
    machine's forced restores run as real engine flows over the
    survivors' NICs, overlapped with training traffic; failure is just
    the "machine leave" case of the general incremental re-plan path),
    (3) resumes — the committed ``ReplanRecord`` (``last_record``)
    carries the state flows the training loop must drain before the
    gated tasks restart;
  * straggler mitigation — at the flow level OES's degree-based rate
    sharing already prevents one slow transfer from starving a NIC
    (Lemma 1); at the step level ``StragglerPolicy`` tracks a robust
    (median + k*MAD) step-time envelope and flags hosts whose sampler
    feeds should be re-provisioned (over-provisioned backup samplers are
    the paper's sampler:worker ratio knob);
  * elastic scaling — ``rescale_plan`` re-runs the planner for a new
    machine set while training is paused at a checkpoint boundary.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..core.cluster import ClusterSpec, Placement
from ..core.engine import DeviceLike
from ..core.placement import etp_search
from ..core.workload import Workload
from ..dynamics.replan import ReplanConfig, Replanner
from . import checkpoint as ckpt_mod


@dataclass
class StragglerPolicy:
    window: int = 50
    k_mad: float = 4.0
    history: List[float] = field(default_factory=list)

    def observe(self, step_time_s: float) -> bool:
        """Returns True if this step is a straggler outlier."""
        h = self.history
        h.append(step_time_s)
        if len(h) > self.window:
            del h[0]
        if len(h) < 8:
            return False
        med = float(np.median(h))
        mad = float(np.median(np.abs(np.asarray(h) - med))) + 1e-9
        return step_time_s > med + self.k_mad * mad


@dataclass
class FailureController:
    """Drives restore -> re-plan -> resume on machine failure.

    Failure handling is one case of the general incremental re-plan path:
    the controller owns a ``Replanner`` whose incumbent tracks the live
    placement, so a failure is ``on_leave`` (remap orphans -> warm ETP
    with the migration bill in the objective) and an elastic scale-up is
    ``on_join`` — both leave the replanner's warm cache state intact.
    ``device`` is where the re-planner's simulations run."""

    workload: Workload
    cluster: ClusterSpec
    placement: Placement
    ckpt_dir: str
    replan_budget: int = 300
    hit_model: Optional[object] = None  # repro_torch.cache.HitModel
    cache_config: Optional[object] = None  # repro_torch.cache.CacheConfig
    device: DeviceLike = None  # where the re-planner's simulations run

    failures: List[int] = field(default_factory=list)
    last_record: Optional[object] = None  # repro_torch.dynamics.ReplanRecord

    def replanner(self, seed: int = 0) -> Replanner:
        """The controller's ONE live re-planner: created on first use and
        kept across calls so its audit records, drift baseline and warm
        cache state survive every failure/join; only the incumbent and
        the search seed are refreshed per call."""
        rp = getattr(self, "_replanner", None)
        if rp is None:
            rp = Replanner(
                self.workload,
                self.cluster,
                self.placement,
                config=ReplanConfig(
                    budget=self.replan_budget, seed=seed, device=self.device
                ),
                hit_model=self.hit_model,
                cache_config=self.cache_config,
            )
            self._replanner = rp
        elif rp.config.seed != seed:
            rp.config = dataclasses.replace(rp.config, seed=seed)
        rp.cluster = self.cluster
        rp.placement = self.placement
        return rp

    def on_failure(self, machine: int, seed: int = 0):
        """Returns (new_cluster, new_placement, replan_result); the full
        ``ReplanRecord`` — including the forced-restore and discretionary
        ``MigrationFlow``s to drain before gated tasks restart — is kept
        on ``self.last_record``."""
        self.failures.append(machine)
        rp = self.replanner(seed)
        rec = rp.on_leave(machine)
        self.last_record = rec
        self.cluster = rp.cluster
        self.placement = rp.placement
        return self.cluster, self.placement, rec.etp

    def on_join(self, machine, seed: int = 0, cache_gb: float = 0.0):
        """Elastic scale-up through the same re-plan path; ``cache_gb``
        is the joining machine's feature-cache budget (heterogeneous)."""
        rp = self.replanner(seed)
        rec = rp.on_join(machine, cache_gb=cache_gb)
        self.last_record = rec
        self.cluster = rp.cluster
        self.placement = rp.placement
        return self.cluster, self.placement, rec.etp

    def restore(self, like_state):
        """``(state, step)`` from the latest complete checkpoint, or
        ``(like_state, 0)`` when there is none."""
        latest = ckpt_mod.latest_checkpoint(self.ckpt_dir)
        if latest is None:
            return like_state, 0
        return ckpt_mod.restore_checkpoint(latest, like_state)


def rescale_plan(
    workload: Workload,
    new_cluster: ClusterSpec,
    *,
    budget: int = 500,
    seed: int = 0,
    device: DeviceLike = None,
):
    """Elastic scale-up/down: full re-plan on the new machine set (called
    at a checkpoint boundary; the data pipeline reshards by step count)."""
    return etp_search(workload, new_cluster, budget=budget, seed=seed, device=device)
