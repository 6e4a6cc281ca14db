"""Infeed planner: the paper's technique applied to the host and DCN layer
of an LM training job.

A copy of the JAX package's ``repro.core.infeed_planner`` over the port's
``plan()``.  Mapping (GNN job -> multi-pod LM job):

  graph store  -> storage/data shard host (holds tokenized shards)
  sampler      -> data-loader/tokenizer host process feeding one pod slice
  worker       -> pod slice executing the train step
  PS flows     -> cross-pod gradient/param sync over DCN (or ring
                  all-reduce flows via sync="allreduce", the extension the
                  paper's conclusion sketches)

Host-level flow volumes come from the arch config + shape: per-step token
bytes (store->loader and loader->pod) and the cross-pod sync volume
(bf16 grads of the active parameters, shrunk by the configured
gradient-compression ratio).  The planner then runs IFS/ETP + OES on the
same torch engine as the GNN experiments, on ``device``, and emits an
``InfeedPlan``: which host loads which shard, and the schedule (on a real
cluster this programs qdisc/DCN QoS; here it drives simulation + tests).

Intra-pod collectives are the training framework's job; the planner
deliberately models only the host/DCN layer, so the two layers compose
without double counting.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from ..models.config import LMConfig
from .cluster import ClusterSpec, Machine
from .dgtp import Plan, plan
from .engine import DeviceLike
from .units import BYTES_PER_GB
from .workload import Workload, build_gnn_workload

#: bytes of one bf16 gradient element
_BF16_BYTES = 2


@dataclass
class LMJobSpec:
    cfg: LMConfig
    global_batch: int
    seq_len: int
    n_pods: int = 2
    loaders_per_pod: int = 2
    n_storage_shards: int = 4
    steps_per_plan: int = 50  # horizon the schedule is optimized over
    step_time_s: float = 0.5  # measured/estimated train_step wall time
    sync: str = "ps"  # "ps" (parameter-server pods) | "allreduce"
    compression_ratio: float = 1.0  # gradient compression (e.g. 0.25)
    bytes_per_token: float = 4.0  # tokenized int32


@dataclass
class InfeedPlan:
    plan: Plan
    workload: Workload
    cluster: ClusterSpec
    shard_of_loader: Dict[int, int]

    @property
    def makespan(self) -> float:
        return self.plan.schedule.makespan

    def summary(self) -> Dict[str, float]:
        return {
            "makespan_s": self.makespan,
            "delta": self.plan.delta,
            "inter_host_gb": self.plan.traffic["inter_machine_gb"],
            "locality": self.plan.traffic["locality_fraction"],
        }


def build_infeed_cluster(spec: LMJobSpec) -> ClusterSpec:
    """Host-level cluster: storage hosts + pod-frontend hosts.

    Storage hosts: 25 GbE; pod frontends: 100 GbE DCN-facing, generous
    CPU for loaders."""
    machines = []
    for i in range(spec.n_storage_shards):
        machines.append(
            Machine(
                name=f"storage{i}",
                resources={"cpu": 16.0, "mem": 64.0},
                bw_in=3.125,
                bw_out=3.125,  # 25 GbE
            )
        )
    for p in range(spec.n_pods):
        machines.append(
            Machine(
                name=f"pod{p}",
                resources={"cpu": 64.0, "mem": 256.0, "gpu": 1.0},
                bw_in=12.5,
                bw_out=12.5,  # 100 GbE DCN
            )
        )
    return ClusterSpec(machines=machines)


def build_infeed_workload(spec: LMJobSpec) -> Workload:
    """Per-step flows of the LM job in the paper's task model."""
    tokens = spec.global_batch * spec.seq_len
    token_gb = tokens * spec.bytes_per_token / BYTES_PER_GB
    loader_gb = token_gb / (spec.n_pods * spec.loaders_per_pod)
    grads_gb = (
        spec.cfg.active_param_count() * _BF16_BYTES / BYTES_PER_GB
        * spec.compression_ratio
    )
    demands = {
        "store": {"cpu": 2.0, "mem": 16.0},
        "sampler": {"cpu": 4.0, "mem": 8.0},  # loader/tokenizer process
        "worker": {"cpu": 8.0, "mem": 32.0, "gpu": 1.0},  # the pod slice's host process
        "ps": {"cpu": 4.0, "mem": 16.0},
    }
    return build_gnn_workload(
        n_stores=spec.n_storage_shards,
        n_workers=spec.n_pods,
        samplers_per_worker=spec.loaders_per_pod,
        n_ps=1,
        n_iters=spec.steps_per_plan,
        store_to_sampler_gb=loader_gb,
        sampler_to_worker_gb=loader_gb,
        grad_gb=grads_gb,
        store_exec_s=0.010,
        sampler_exec_s=0.030,  # tokenize/pack
        worker_exec_s=spec.step_time_s,
        ps_exec_s=0.010,
        pmr=1.02,  # fixed-shape LM batches barely fluctuate
        sync=spec.sync,
        demands=demands,
    )


def plan_infeed(
    spec: LMJobSpec,
    *,
    budget: int = 500,
    seed: int = 0,
    n_chains: Optional[int] = None,
    device: DeviceLike = None,
) -> InfeedPlan:
    """Plan the job's host layer with ``plan()`` on ``device`` (``None``:
    the CUDA card); ``n_chains`` as ``plan()`` takes it (``None``: the
    device's default, ``DEFAULT_N_CHAINS``)."""
    cluster = build_infeed_cluster(spec)
    workload = build_infeed_workload(spec)
    p = plan(
        workload, cluster, budget=budget, seed=seed,
        sim_iters=min(20, spec.steps_per_plan), n_chains=n_chains,
        device=device,
    )
    shard_of_loader: Dict[int, int] = {}
    for w, loaders in workload.sampler_of_worker.items():
        for s in loaders:
            shard_of_loader[s] = int(p.placement.y[s]) % spec.n_storage_shards
    return InfeedPlan(
        plan=p, workload=workload, cluster=cluster, shard_of_loader=shard_of_loader
    )
