"""Dynamics walkthrough on the PyTorch port: bandwidth drift -> detect ->
warm re-plan -> elastic churn -> traffic-class shaping.

    python3 examples/dynamic_replan_torch.py                 # on a CUDA card
    python3 examples/dynamic_replan_torch.py --device cpu    # on the CPU

``examples/dynamic_replan.py`` on ``repro_torch``: the ogbn-products
testbed job on a cluster whose NICs drift over time, comparing the
static plan against warm incremental re-planning (drift-thresholded,
amortised over the remaining run) whose committed state moves ride the
true simulation as real migration flows, and the oracle bound; then
machine leave and join through the same re-plan path, with forced
restores billed as flows on the survivors' NICs; then the three shaping
modes of the restore flows.  Every simulation runs on ``--device``.
The scenario records every committed interval, and the critical-path
blame splits the static-vs-replan wall-clock gap into named components.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import (  # noqa: E402
    OGBN_PRODUCTS,
    build_workload_from_profile,
    ifs_placement,
    simulate_torch,
    testbed_cluster,
)
from repro_torch.core.cluster import Machine  # noqa: E402
from repro_torch.dynamics import (  # noqa: E402
    ReplanConfig,
    Replanner,
    drift_trace,
    run_scenario,
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where every simulation runs (default: cuda)")
    args = ap.parse_args(argv)
    dev = args.device
    n_intervals, iters = 4, 8
    wl = build_workload_from_profile(
        OGBN_PRODUCTS, n_stores=4, n_workers=4, samplers_per_worker=2,
        n_ps=1, n_iters=n_intervals * iters,
    )
    cluster = testbed_cluster()
    p0 = ifs_placement(wl, cluster, seed=0)
    undisturbed = simulate_torch(
        wl, cluster, p0, wl.realize(seed=0, n_iters=n_intervals * iters),
        device=dev,
    ).makespan
    trace = drift_trace(
        cluster, horizon_s=undisturbed * 1.2, n_segments=3 * n_intervals,
        seed=0, bw_scale_range=(0.25, 1.0),
    )
    print(f"device {dev}; undisturbed makespan {undisturbed:.2f}s; drift "
          f"trace with {trace.S} segments (NICs drop to 25-100%, occasional "
          "stragglers)")

    cfg = ReplanConfig(budget=120, sim_iters=iters, drift_threshold=0.2,
                       device=dev)
    print("\n== static plan vs warm incremental re-planning ==")
    outcomes = {}
    for strat in ("static", "replan", "oracle"):
        out = run_scenario(
            wl, cluster, trace, strategy=strat,
            n_intervals=n_intervals, iters_per_interval=iters, seed=0,
            replan_config=cfg, oracle_budget=360, collect_traces=True,
        )
        outcomes[strat] = out
        print(f"  {strat:7s}: total {out.total_s:7.2f}s  "
              f"(compute {out.compute_s:.2f}s + overlapped migration "
              f"{out.overlap_total_s:.2f}s, {out.n_replans} re-plans)")
    gain = 100 * (1 - outcomes["replan"].total_s / outcomes["static"].total_s)
    oracle = 100 * (1 - outcomes["oracle"].total_s / outcomes["static"].total_s)
    print(f"  re-planning recovers {gain:.1f}% of the static wall-clock "
          f"(oracle bound: {oracle:.1f}%)")
    rp = outcomes["replan"]
    print(f"  migration as flows: actually paid {rp.overlap_total_s:.3f}s "
          f"overlapped vs {rp.migration_total_s:.3f}s serial drain bill "
          f"(serial books would read {rp.serial_total_s:.2f}s total)")

    print("\n== where did the time go? (repro_torch.obs critical-path blame) ==")
    # collect_traces=True recorded every committed interval; blame() walks
    # each interval's critical path and the components sum to its makespan,
    # so the static-vs-replan wall-clock gap decomposes exactly into named
    # deltas — the delta column sums to the makespan delta
    from repro_torch.obs import blame_delta

    rep_static = outcomes["static"].blame()
    rep_replan = outcomes["replan"].blame()
    for line in blame_delta(
        rep_static, rep_replan, "static", "replan"
    ).splitlines():
        print("  " + line)
    dsum = sum(
        rep_replan.components[k] - rep_static.components[k]
        for k in rep_replan.components
    )
    dmk = rep_replan.makespan - rep_static.makespan
    assert abs(dsum - dmk) < 1e-6 * max(1.0, abs(dmk)), (dsum, dmk)
    print(f"  component deltas sum to the makespan delta: "
          f"{dsum:+.3f}s == {dmk:+.3f}s")

    print("\n== elastic membership through the same path ==")
    rp = Replanner(wl, cluster, p0.copy(), config=cfg)
    rec = rp.on_leave(3)
    print(f"  machine 3 left  -> {rp.cluster.M} machines: forced restores "
          f"{rec.forced_gb:.2f} GB over survivor NICs + {rec.moved_tasks} "
          f"discretionary moves ({rec.migration_gb:.2f} GB); drain bound "
          f"{rec.migration_s:.2f}s, simulated overlap {rec.overlap_s:.2f}s; "
          f"makespan {rec.makespan:.2f}s, objective {rec.objective:.2f}s")
    joiner = Machine("m-join", {"mem": 48.0, "cpu": 16.0, "gpu": 2.0}, 6.25, 6.25)
    rec = rp.on_join(joiner)
    print(f"  machine joined  -> {rp.cluster.M} machines, moved "
          f"{rec.moved_tasks} tasks (overlap {rec.overlap_s:.2f}s of "
          f"{rec.migration_s:.2f}s drain bound), makespan {rec.makespan:.2f}s")
    print("  triggers:", [r.trigger for r in rp.records])

    print("\n== traffic-class shaping of the restore flows ==")
    print("  ReplanConfig(shaping=...): None = migration competes as an "
          "equal; 'strict' = leftover capacity only; 'deadline' = strict "
          "until the gated task's clean-slack runs out, then escalate")
    overlaps = {}
    for mode in (None, "strict", "deadline"):
        rp = Replanner(
            wl, cluster, p0.copy(),
            config=ReplanConfig(budget=120, sim_iters=iters, shaping=mode,
                                device=dev),
        )
        rec = rp.on_leave(3)
        overlaps[mode] = rec.overlap_s
        print(f"  shaping={str(mode):8s}: restore overlap actually paid "
              f"{rec.overlap_s:.3f}s (drain bound {rec.migration_s:.2f}s), "
              f"makespan {rec.makespan:.2f}s")
    return {"outcomes": outcomes, "shaping_overlap": overlaps}


if __name__ == "__main__":
    main()
