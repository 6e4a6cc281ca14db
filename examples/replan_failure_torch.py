"""Fault-tolerance walkthrough on the PyTorch port: machine failure ->
restore + re-plan -> resume.

    python3 examples/replan_failure_torch.py                 # on a CUDA card
    python3 examples/replan_failure_torch.py --device cpu    # on the CPU

``examples/replan_failure.py`` on ``repro_torch``: the ogbn-products
testbed job on 6 heterogeneous machines; machine 2 fails, and
``FailureController.on_failure`` re-plans the placement on the five
survivors through the warm re-plan path.  Every simulation runs on
``--device``; ``--budget`` is the re-plan's search budget (default 300,
the reference's ``replan_budget``).
"""
import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import (  # noqa: E402
    OGBN_PRODUCTS,
    build_workload_from_profile,
    heterogeneous_cluster,
    ifs_placement,
    simulate_torch,
)
from repro_torch.train.fault_tolerance import FailureController  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where every simulation runs (default: cuda)")
    ap.add_argument("--budget", type=int, default=300,
                    help="the re-plan's search budget (default: 300)")
    args = ap.parse_args(argv)
    dev = args.device

    wl = build_workload_from_profile(
        OGBN_PRODUCTS, n_stores=4, n_workers=6, samplers_per_worker=2,
        n_ps=1, n_iters=30,
    )
    cluster = heterogeneous_cluster(6, seed=7)
    placement = ifs_placement(wl, cluster, seed=0)
    r = wl.realize(seed=0)
    before = simulate_torch(wl, cluster, placement, r, policy="oes", device=dev).makespan
    print(f"device {dev}")
    print(f"6 machines, makespan {before:.2f}s")

    with tempfile.TemporaryDirectory() as ckpt_dir:
        fc = FailureController(wl, cluster, placement, ckpt_dir=ckpt_dir,
                               replan_budget=args.budget, device=dev)
        new_cluster, new_placement, res = fc.on_failure(machine=2, seed=0)
    after = simulate_torch(wl, new_cluster, new_placement, r, policy="oes",
                           device=dev).makespan
    print(
        f"machine 2 failed -> re-planned on {new_cluster.M} machines in "
        f"{res.wall_time_s:.1f}s ({res.evaluations} evals), makespan {after:.2f}s"
    )
    print(f"degradation: {100*(after/before-1):.1f}% (graceful, not fatal)")
    return fc, before, after


if __name__ == "__main__":
    main()
