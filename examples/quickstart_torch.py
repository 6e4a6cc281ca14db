"""Quickstart on the PyTorch port: plan a distributed GNN training job
with DGTP.

    python3 examples/quickstart_torch.py                 # on a CUDA card
    python3 examples/quickstart_torch.py --device cpu    # on the CPU

``examples/quickstart.py`` on ``repro_torch``: builds the paper's
testbed job (4 servers, 6 workers x 2 samplers, 1 PS, ogbn-products
profile), searches a placement with ETP, schedules with OES, and prints
the plan + the Theorem-1 certificate, compared against the DistDGL /
OMCoflow / MRTF baselines.  Closes with the observability tier:
re-simulate the winning plan with ``record=True``, lift the flow log into
a ``ScheduleTrace``, print the critical-path blame table, and export a
Chrome/Perfetto ``trace.json`` beside this file that you can drop into
https://ui.perfetto.dev (machines render as processes, task/flow spans as
slices, per-machine NIC utilization as counter tracks).  Every
simulation runs on ``--device``; ``--budget`` is the ETP search budget.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import (  # noqa: E402
    OGBN_PRODUCTS,
    build_workload_from_profile,
    plan,
    plan_baseline,
    simulate_torch,
    testbed_cluster,
)
from repro_torch.core.units import BITS_PER_BYTE  # noqa: E402
from repro_torch.obs import ScheduleTrace, blame, write_trace  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where every simulation runs (default: cuda)")
    ap.add_argument("--budget", type=int, default=600,
                    help="ETP search budget (default: 600, the reference's)")
    ap.add_argument("--out", default=str(Path(__file__).resolve().parent / "trace.json"),
                    help="where the Perfetto trace is written")
    args = ap.parse_args(argv)
    dev = args.device

    wl = build_workload_from_profile(
        OGBN_PRODUCTS, n_stores=4, n_workers=6, samplers_per_worker=2,
        n_ps=1, n_iters=40,
    )
    cluster = testbed_cluster()
    r = wl.realize(seed=0)
    print(f"device {dev}")

    print("== DGTP (ETP placement + OES scheduling) ==")
    p = plan(wl, cluster, realization=r, budget=args.budget, sim_iters=15,
             seed=0, device=dev)
    names = wl.task_names()
    for m in range(cluster.M):
        tasks = [names[j] for j in range(wl.J) if p.placement.y[j] == m]
        bw = cluster.machines[m].bw_in * BITS_PER_BYTE
        print(f"  {cluster.machines[m].name} ({bw:.0f} Gbps): {', '.join(tasks)}")
    print(f"  makespan          = {p.schedule.makespan:.2f} s")
    print(f"  Delta (eq. 20)    = {p.delta}")
    print(f"  chain lower bound = {p.certificate.lower_bound:.2f} s")
    print(f"  T_OES <= Delta*LB : {p.certificate.holds}")
    print(f"  inter-machine GB  = {p.traffic['inter_machine_gb']:.1f}")

    print("\n== baselines (same realization) ==")
    dd = plan_baseline(wl, cluster, baseline="distdgl", realization=r, device=dev)
    print(f"  DistDGL (colocate + FIFO): {dd.schedule.makespan:.2f} s")
    for pol in ("omcoflow", "mrtf"):
        res = simulate_torch(wl, cluster, p.placement, r, policy=pol, device=dev)
        print(f"  {pol:8s} (DGTP placement): {res.makespan:.2f} s")
    sp = 100 * (1 - p.schedule.makespan / dd.schedule.makespan)
    print(f"\nDGTP speedup over DistDGL: {sp:.1f}%")

    print("\n== tracing the winning schedule (repro_torch.obs) ==")
    # record=True keeps the per-flow log; the trace lifts it into spans +
    # per-machine NIC utilization timelines
    res = simulate_torch(wl, cluster, p.placement, r, record=True, device=dev)
    tr = ScheduleTrace.from_result(res, wl, cluster, p.placement, r)
    rep = blame(tr)
    print(rep.table(label="  oes"))
    obj = write_trace(tr, args.out)
    n_x = sum(1 for e in obj["traceEvents"] if e["ph"] == "X")
    n_c = sum(1 for e in obj["traceEvents"] if e["ph"] == "C")
    print(f"  wrote {args.out} ({n_x} slices, {n_c} counter samples) "
          f"-- open it at https://ui.perfetto.dev")
    return p, dd, tr, rep


if __name__ == "__main__":
    main()
