"""Carry the JAX package's planning inputs across to the port.

``from_reference(obj)`` turns a ``repro`` ``Workload``, ``ClusterSpec``,
``Placement`` or ``Realization`` into the port's own class of the same
name.  It reads the object's plain fields and numpy arrays by attribute
(duck-typed), so nothing of ``repro`` is imported; arrays are copied.
``sage_from_reference(params, cfg)`` builds the port's ``GraphSAGE`` with
the weights of the JAX package's ``init_sage`` parameter dict.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .core.cluster import ClusterSpec, Machine, Placement, TaskSpec
from .core.engine import DeviceLike
from .core.workload import Edge, Realization, TrafficModel, Workload
from .models.gnn import GraphSAGE, SageConfig


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


def from_reference(obj: Any) -> Any:
    """The port's counterpart of a reference planning object."""
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
