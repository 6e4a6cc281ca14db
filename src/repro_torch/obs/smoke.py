"""Obs smoke: export + validate a Perfetto trace from a golden schedule.

    PYTHONPATH=src python -m repro_torch.obs.smoke --device cpu [--out trace.json]

Simulates the golden suite's fan-in job on the torch engine (recorded),
lifts it into a ``ScheduleTrace``, checks the conservation invariants
inline (blame components sum to the makespan; NIC utilization integrals
equal delivered bytes), exports ``trace.json`` and re-validates the file
as read back from disk.  Without ``--device`` it runs on the CUDA card,
and raises when there is none.
"""
from __future__ import annotations

import argparse
import json
from typing import List, Optional

import numpy as np

from ..core import (
    build_gnn_workload,
    heterogeneous_cluster,
    ifs_placement,
    simulate_torch,
)
from ..core.engine import DeviceLike
from .blame import blame
from .perfetto import validate_trace_events, write_trace
from .trace import ScheduleTrace


def golden_trace(policy: str = "oes", *, device: DeviceLike = None) -> ScheduleTrace:
    """The golden suite's fan-in job as a recorded ScheduleTrace, simulated
    on ``device`` (``None``: the CUDA card)."""
    wl = build_gnn_workload(
        n_stores=2, n_workers=2, samplers_per_worker=2, n_ps=1, n_iters=4,
        store_to_sampler_gb=1.0, sampler_to_worker_gb=0.5, grad_gb=0.2,
        store_exec_s=0.3, sampler_exec_s=0.4, worker_exec_s=0.8,
        ps_exec_s=0.2, pmr=1.3,
    )
    cluster = heterogeneous_cluster(3, seed=0)
    placement = ifs_placement(wl, cluster, seed=0)
    realization = wl.realize(seed=0)
    res = simulate_torch(
        wl, cluster, placement, realization, policy=policy, record=True,
        device=device,
    )
    return ScheduleTrace.from_result(
        res, wl, cluster, placement, realization
    )


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="trace.json")
    ap.add_argument("--policy", default="oes")
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: the CUDA card)")
    args = ap.parse_args(argv)

    tr = golden_trace(args.policy, device=args.device)
    rep = blame(tr)
    assert abs(rep.residual) < 1e-6 * max(1.0, tr.makespan), (
        f"blame components do not conserve the makespan: "
        f"residual={rep.residual}"
    )
    for m in range(tr.M):
        got = tr.utilization_integral(m, "in")
        want = tr.delivered_gb(m, "in")
        assert np.isclose(got, want, rtol=1e-9, atol=1e-9), (
            f"machine {m}: utilization integral {got} != delivered {want}"
        )
    write_trace(tr, args.out)
    with open(args.out) as fh:
        counts = validate_trace_events(json.load(fh))
    print(rep.table(f"golden fan-in ({args.policy})"))
    print(
        f"exported {args.out}: "
        + " ".join(f"{k}={v}" for k, v in sorted(counts.items()))
        + " — load it at ui.perfetto.dev"
    )


if __name__ == "__main__":
    main()
