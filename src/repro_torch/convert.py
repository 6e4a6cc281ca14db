"""Carry the JAX package's planning inputs across to the port.

``from_reference(obj)`` turns a ``repro`` ``Workload``, ``ClusterSpec``,
``Placement``, ``Realization``, ``MigrationFlow``, ``BandwidthTrace``,
``DynamicsEvent``, ``ReplanConfig``, ``MergedJob``, ``JobArrival``,
``ServiceConfig``, ``AccessTrace``, ``HitModel`` or ``CacheConfig`` into
the port's own class of the same name (a ``ReplanConfig``'s or
``ServiceConfig``'s ``backend`` becomes ``device=``).  It
reads the object's plain fields and numpy arrays by attribute
(duck-typed), so nothing of ``repro`` is imported; arrays are copied.
``sage_from_reference(params, cfg)`` builds the port's ``GraphSAGE`` with
the weights of the JAX package's ``init_sage`` parameter dict, and
``lm_from_reference(params, cfg)`` the port's ``TransformerLM`` (any of
the six block patterns, either frontend) with those of
``TransformerLM.init``; ``lm_to_reference(model)`` turns the port's
weights (or their gradients) back into that tree.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch

from .cache.adjust import CacheConfig
from .cache.hitmodel import HitModel
from .cache.trace import AccessTrace
from .core.cluster import ClusterSpec, Machine, Placement, TaskSpec
from .core.engine import DeviceLike, MigrationFlow
from .core.multijob import MergedJob
from .core.workload import Edge, Realization, TrafficModel, Workload
from .dynamics.arrivals import JobArrival, ServiceConfig
from .dynamics.replan import ReplanConfig
from .dynamics.traces import BandwidthTrace, DynamicsEvent
from .models.config import BLOCK_PATTERNS, FRONTENDS, LMConfig, MoESpec, SSMSpec
from .models.gnn import GraphSAGE, SageConfig
from .models.model import TransformerLM
from .train.optimizer import tree_build


def _traffic(t: Any) -> TrafficModel:
    fl = t.fluctuating
    return TrafficModel(
        mean_volume=np.array(t.mean_volume, dtype=np.float64),
        mean_exec=np.array(t.mean_exec, dtype=np.float64),
        pmr=float(t.pmr),
        exec_jitter=float(t.exec_jitter),
        fluctuating=None if fl is None else np.array(fl, dtype=bool),
    )


def _task(t: Any) -> TaskSpec:
    return TaskSpec(name=t.name, kind=t.kind, demand=dict(t.demand))


def _edge(e: Any) -> Edge:
    return Edge(src=int(e.src), dst=int(e.dst), lag=int(e.lag), kind=e.kind)


def _machine(m: Any) -> Machine:
    return Machine(
        name=m.name, resources=dict(m.resources), bw_in=float(m.bw_in),
        bw_out=float(m.bw_out),
    )


def _copy_fields(cls: Any, obj: Any, **override: Any) -> Any:
    """An instance of dataclass ``cls`` from ``obj``'s fields of the same
    names (``override`` replaces some)."""
    kw = {f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)
          if f.name not in override}
    return cls(**kw, **override)


def from_reference(obj: Any, *, device: DeviceLike = None) -> Any:
    """The port's counterpart of a reference planning object; ``device``
    is the converted ``ReplanConfig``'s or ``ServiceConfig``'s (the
    reference's ``backend`` names an engine, not a device, so it is not
    carried; a ``ServiceConfig``'s ``replan_config`` gets the same
    ``device``)."""
    if hasattr(obj, "admit_margin") and hasattr(obj, "max_defer"):
        rc = obj.replan_config
        return _copy_fields(
            ServiceConfig, obj, device=device,
            replan_config=None if rc is None else from_reference(rc, device=device),
        )
    if hasattr(obj, "t_arrive") and hasattr(obj, "deadline_s"):
        return _copy_fields(JobArrival, obj, workload=from_reference(obj.workload))
    if hasattr(obj, "task_offsets") and hasattr(obj, "job_seeds"):
        return MergedJob(
            workload=from_reference(obj.workload),
            task_offsets=[int(o) for o in obj.task_offsets],
            n_iters=[int(n) for n in obj.n_iters],
            jobs=None if obj.jobs is None else [from_reference(j) for j in obj.jobs],
            job_seeds=None if obj.job_seeds is None else [int(t) for t in obj.job_seeds],
            names=None if obj.names is None else list(obj.names),
        )
    if hasattr(obj, "accesses") and hasattr(obj, "bytes_per_node"):
        return AccessTrace(
            accesses=[[np.array(a, dtype=np.int64) for a in s] for s in obj.accesses],
            n_nodes=int(obj.n_nodes),
            bytes_per_node=int(obj.bytes_per_node),
        )
    if hasattr(obj, "capacity_nodes") and hasattr(obj, "warm_iters"):
        # the memoised replay table travels too: it is what the replay gives
        return HitModel(
            trace=from_reference(obj.trace),
            policy=obj.policy,
            capacity_nodes=int(obj.capacity_nodes),
            warm_iters=int(obj.warm_iters),
            _table={int(k): np.array(v, dtype=np.float64)
                    for k, v in obj._table.items()},
        )
    if hasattr(obj, "reserve_mem") and hasattr(obj, "cache_gb"):
        gb = obj.cache_gb
        return CacheConfig(
            policy=obj.policy,
            cache_gb=float(gb) if np.ndim(gb) == 0 else np.array(gb, dtype=np.float64),
            reserve_mem=bool(obj.reserve_mem),
        )
    if hasattr(obj, "drift_threshold") and hasattr(obj, "migration_weight"):
        return _copy_fields(ReplanConfig, obj, device=device)
    if hasattr(obj, "times") and hasattr(obj, "slow"):
        return BandwidthTrace(
            times=np.array(obj.times, dtype=np.float64),
            bw_in=np.array(obj.bw_in, dtype=np.float64),
            bw_out=np.array(obj.bw_out, dtype=np.float64),
            slow=np.array(obj.slow, dtype=np.float64),
        )
    if hasattr(obj, "bw_scale") and hasattr(obj, "slowdown"):
        return _copy_fields(DynamicsEvent, obj)
    if hasattr(obj, "gb") and hasattr(obj, "deadline"):
        return _copy_fields(MigrationFlow, obj)
    if hasattr(obj, "tasks") and hasattr(obj, "edges") and hasattr(obj, "traffic"):
        return Workload(
            tasks=[_task(t) for t in obj.tasks],
            edges=[_edge(e) for e in obj.edges],
            traffic=_traffic(obj.traffic),
            n_iters=int(obj.n_iters),
            sampler_of_worker={
                int(k): [int(s) for s in v]
                for k, v in obj.sampler_of_worker.items()
            },
            store_tasks=[int(g) for g in obj.store_tasks],
            is_merged=bool(obj.is_merged),
        )
    if hasattr(obj, "machines"):
        return ClusterSpec(machines=[_machine(m) for m in obj.machines])
    if hasattr(obj, "volumes") and hasattr(obj, "exec_times"):
        return Realization(
            volumes=np.array(obj.volumes, dtype=np.float64),
            exec_times=np.array(obj.exec_times, dtype=np.float64),
        )
    if hasattr(obj, "y"):
        return Placement(np.array(obj.y, dtype=np.int64))
    raise TypeError(f"no port counterpart for {type(obj).__name__}")


def sage_from_reference(
    params: Mapping[str, Any], cfg: Any, *, device: DeviceLike = None,
) -> GraphSAGE:
    """The port's GraphSAGE holding the reference's weights.

    ``params`` is the reference's ``init_sage`` dict as arrays (``w{l}``
    [2·d_l, d_{l+1}], ``b{l}`` [d_{l+1}], ``head`` [hidden, n_classes]);
    ``cfg`` is read for ``in_dim``, ``hidden``, ``n_classes`` and
    ``n_layers``.  ``nn.Linear`` stores [out, in], so the matrices are
    transposed."""
    port_cfg = SageConfig(
        in_dim=int(cfg.in_dim), hidden=int(cfg.hidden),
        n_classes=int(cfg.n_classes), n_layers=int(cfg.n_layers),
    )
    model = GraphSAGE(port_cfg, device=device)

    def _t(a: Any) -> torch.Tensor:
        return torch.as_tensor(np.array(a, dtype=np.float32))

    with torch.no_grad():
        for l, lin in enumerate(model.layers):
            lin.weight.copy_(_t(params[f"w{l}"]).T)
            lin.bias.copy_(_t(params[f"b{l}"]))
        model.head.weight.copy_(_t(params["head"]).T)
    return model


def lm_config_from_reference(cfg: Any) -> LMConfig:
    """The port's ``LMConfig`` of a reference ``ModelConfig``: every field
    the port has, read by name (the ``moe`` and ``ssm`` specs too).
    Raises ``ValueError`` for a block pattern or frontend that the port
    does not know."""
    if cfg.block_pattern not in BLOCK_PATTERNS or cfg.frontend not in FRONTENDS:
        raise ValueError(
            f"{cfg.name}: the port runs the {BLOCK_PATTERNS} block patterns and "
            f"the frontends {FRONTENDS}; got {cfg.block_pattern!r}, "
            f"{cfg.frontend!r}"
        )

    def spec(cls: Any, ref: Any) -> Any:
        if ref is None:
            return None
        return cls(**{f.name: getattr(ref, f.name) for f in dataclasses.fields(cls)})

    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(LMConfig)}
    fields["moe"] = spec(MoESpec, cfg.moe)
    fields["ssm"] = spec(SSMSpec, cfg.ssm)
    return LMConfig(**fields)


def lm_from_reference(
    params: Mapping[str, Any], cfg: Any, *, device: DeviceLike = None,
) -> TransformerLM:
    """The port's TransformerLM holding the reference's weights.

    ``params`` is the pytree of the reference's ``TransformerLM.init``
    (blocks stacked over layers on axis 0; ``final_norm`` stacked over
    one; zamba2's ``shared`` block too), as arrays of any float dtype; each
    is read as fp32 and cast to the parameter's dtype (exact for bf16
    weights).  The layer mappings hold the reference's names: ``attn``,
    ``mlp`` or ``moe`` (router, w_gate, w_up, w_down), ``ln_attn`` and
    ``ln_mlp``, and for gemma2 ``ln_attn_post`` and ``ln_mlp_post``; a
    mamba2 or zamba2 layer holds wz, wx, wB, wC, wdt, conv_x, conv_B,
    conv_C, A_log, D, dt_bias, norm_scale, ln and out_proj.  A frames
    model's tree has no ``embed``."""
    model = TransformerLM(lm_config_from_reference(cfg), device=device)

    def put(dst: torch.Tensor, src: Any) -> None:
        dst.copy_(torch.from_numpy(np.array(src, dtype=np.float32)))

    def dense(blk: Any, tree: Mapping[str, Any], l: int) -> None:
        for group, _ in blk.named_children():
            for name, w in blk[group].items():
                put(w, tree[group][name][l])

    with torch.no_grad():
        if model.embed is not None:
            put(model.embed, params["embed"])
        if model.head is not None:
            put(model.head, params["head"])
        for name, w in model.final_norm.items():
            put(w, params["final_norm"][name][0])
        blocks = params["blocks"]
        for l, blk in enumerate(model.blocks):
            if model.cfg.block_pattern in ("mamba2", "zamba2"):
                for name, w in blk.items():
                    put(w, blocks[name][l])
            else:
                dense(blk, blocks, l)
        if model.shared is not None:
            dense(model.shared, params["shared"], 0)
    return model


def lm_to_reference(model: TransformerLM, *, grads: bool = False) -> Dict[str, Any]:
    """The inverse of ``lm_from_reference``: the port's parameters (or,
    with ``grads``, their ``.grad``, zeros where none) as the pytree of the
    reference's ``TransformerLM.init``, blocks stacked over the layers on
    axis 0, ``final_norm`` and zamba2's ``shared`` block over one; every
    leaf an fp32 numpy array (exact for bf16 values)."""

    def value(p: torch.Tensor) -> np.ndarray:
        t = p.grad if grads else p
        if t is None:
            t = torch.zeros_like(p)
        return t.detach().float().cpu().numpy()

    items = []
    for path, params, stacked in model.leaf_groups():
        arrays = [value(p) for p in params]
        items.append((path, np.stack(arrays) if stacked else arrays[0]))
    return tree_build(items)
