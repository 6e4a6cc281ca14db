"""Feature-cache walkthrough on the PyTorch port: trace -> hit rates ->
traffic -> placement.

    python3 examples/cache_sweep_torch.py                 # on a CUDA card
    python3 examples/cache_sweep_torch.py --device cpu    # on the CPU

``examples/cache_sweep.py`` on ``repro_torch``: collects a sampler access
trace from the synthetic graph, sweeps cache size across the three
policies (static hotness tiering, shared LRU, deterministic-sampling
prefetch), shows how the cache tier reshapes the paper's store->sampler
traffic and the resulting makespan, then runs cache-aware ETP against
the cache-oblivious search on a skewed job where their optima split.
The trace and the replays are numpy; every simulation runs on
``--device``.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402

from repro_torch.cache import (  # noqa: E402
    CacheConfig,
    build_hit_model,
    cache_adjusted_realization,
    cache_aware_etp,
    cache_cost_fns,
    collect_trace,
    replay,
    samplers_per_machine,
    static_hit_rate_estimate,
)
from repro_torch.core import simulate_torch, testbed_cluster  # noqa: E402
from repro_torch.core.placement import etp_multichain, ifs_placement  # noqa: E402
from repro_torch.core.workload import build_gnn_workload  # noqa: E402
from repro_torch.data.graph import synthetic_graph  # noqa: E402


def skewed_job():
    """g2s-dominated job with 70% of the graph volume on slow-NIC machine 2."""
    return build_gnn_workload(
        n_stores=4, n_workers=4, samplers_per_worker=2, n_ps=1, n_iters=10,
        store_to_sampler_gb=0.8, sampler_to_worker_gb=0.05, grad_gb=0.01,
        store_exec_s=0.02, sampler_exec_s=0.04, worker_exec_s=0.06,
        ps_exec_s=0.01, store_skew=[0.1, 0.1, 0.7, 0.1],
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where every simulation runs (default: cuda)")
    args = ap.parse_args(argv)
    dev = args.device

    # -- 1. trace the port's sampler ---------------------------------------
    g = synthetic_graph(n_nodes=2000, avg_degree=12, n_feats=16, n_parts=4, seed=0)
    trace = collect_trace(
        g, n_samplers=8, seeds_per_iter=16, fanouts=(4, 4), n_iters=12, seed=0
    )
    sizes = np.mean([len(a) for s in trace.accesses for a in s])
    print(f"device {dev}; trace: 8 samplers x 12 iters, mean fetch set "
          f"{sizes:.0f} of {g.n_nodes} nodes")

    # -- 2. hit-rate sweep ---------------------------------------------------
    print("\nmean hit rate vs capacity (2 samplers sharing one cache):")
    print("  nodes   static     lru  prefetch")
    for cap in (100, 300, 600, 1200):
        row = [float(replay(trace, pol, cap, k=2).mean())
               for pol in ("static", "lru", "prefetch")]
        print(f"  {cap:5d}  {row[0]:7.3f} {row[1]:7.3f}  {row[2]:7.3f}")
    est = static_hit_rate_estimate(trace, 600)
    meas = float(replay(trace, "static", 600, k=1).mean())
    print(f"closed-form static estimate @600: {est:.3f} (trace replay {meas:.3f})")

    # -- 3. cache-adjusted traffic and makespan ------------------------------
    wl = skewed_job()  # hot partition on a slow-NIC machine
    cluster = testbed_cluster()
    p0 = ifs_placement(wl, cluster, seed=0)
    r = wl.realize(seed=0)
    base = simulate_torch(wl, cluster, p0, r, policy="oes", device=dev).makespan
    print(f"\nuncached makespan (IFS placement): {base:.2f}s")
    for cap in (150, 600):
        model = build_hit_model(trace, policy="lru", capacity_nodes=cap)
        adj = cache_adjusted_realization(wl, cluster, p0, r, model)
        mk = simulate_torch(wl, cluster, p0, adj, policy="oes", device=dev).makespan
        shrink = 100 * (1 - adj.volumes.sum() / r.volumes.sum())
        print(f"  lru cache {cap:4d} nodes: traffic -{shrink:.0f}%, makespan {mk:.2f}s")

    # -- 4. cache-aware vs cache-oblivious placement -------------------------
    model = build_hit_model(trace, policy="prefetch", capacity_nodes=150)
    cfg = CacheConfig(policy="prefetch", cache_gb=1.0)
    kw = dict(n_chains=8, budget=160, sim_iters=8, seed=0, device=dev)
    oblivious = etp_multichain(wl, cluster, **kw)
    aware = cache_aware_etp(wl, cluster, model, cfg, sim_draws=1, **kw)
    _, judge, _ = cache_cost_fns(wl, cluster, model, sim_iters=8, sim_draws=3,
                                 seed=123, device=dev)
    mk_obl, mk_awr = judge([oblivious.placement, aware.placement])
    print("\ncache-aware vs cache-oblivious ETP (judged under cache-adjusted traffic):")
    print(f"  oblivious: {mk_obl:.2f}s  samplers/machine "
          f"{samplers_per_machine(wl, cluster, oblivious.placement).tolist()}")
    print(f"  aware:     {mk_awr:.2f}s  samplers/machine "
          f"{samplers_per_machine(wl, cluster, aware.placement).tolist()}")
    print(f"  gain: {100 * (1 - mk_awr / mk_obl):.1f}% "
          "(prefetch buffers are per machine — stacking samplers divides them)")
    return mk_obl, mk_awr


if __name__ == "__main__":
    main()
