"""End-to-end driver on PyTorch: GraphSAGE training with DGTP planning.

    python examples/train_graphsage_torch.py [--steps 60] [--device cpu]

The twin of examples/train_graphsage.py on the port (``repro_torch``):
synthetic partitioned graph (4 stores) -> fixed-fanout samplers
(measuring real per-store traffic) -> GraphSAGE training with SGD on
the card (the aggregation on the CUDA kernel; ``--device cpu`` runs the
kernel's plain version).  The measured traffic calibrates the cluster
model; DGTP plans placement + flow schedule and the run reports the
learning curve and the simulated makespan vs DistDGL.
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np

from repro_torch.core import plan, plan_baseline, resolve_device, testbed_cluster
from repro_torch.core.units import BYTES_PER_GB, BYTES_PER_MIB
from repro_torch.core.workload import build_gnn_workload
from repro_torch.data.graph import sample_blocks, synthetic_graph
from repro_torch.models import GraphSAGE, SageConfig, batch_to, sage_loss, sgd_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    g = synthetic_graph(n_nodes=8000, n_parts=4, seed=0)
    cfg = SageConfig(in_dim=100, hidden=128, n_classes=47, n_layers=3)
    model = GraphSAGE(cfg, device=device, seed=0)
    rng = np.random.default_rng(0)

    store_bytes = []
    t0 = time.time()
    for step in range(args.steps):
        seeds = rng.choice(g.train_nodes, args.batch, replace=False)
        feats, blocks, labels, per_store = sample_blocks(g, seeds, (5, 10, 15), rng)
        store_bytes.append(sum(per_store.values()))
        loss, m = sage_loss(model, batch_to(feats, blocks, labels, device=device))
        loss.backward()
        sgd_step(model, lr=0.1)
        if step % 10 == 0 or step == args.steps - 1:
            print(
                f"step {step:4d} loss {m['loss'].item():.3f} "
                f"acc {m['acc'].item():.3f} "
                f"sampled {store_bytes[-1] / BYTES_PER_MIB:.1f} MiB"
            )
    print(f"trained {args.steps} steps in {time.time() - t0:.1f}s on {device}")

    # calibrate the planner with MEASURED traffic and plan the deployment
    vol_gb = float(np.mean(store_bytes)) / BYTES_PER_GB
    param_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    wl = build_gnn_workload(
        n_stores=4, n_workers=6, samplers_per_worker=2, n_ps=1, n_iters=40,
        store_to_sampler_gb=vol_gb, sampler_to_worker_gb=vol_gb,
        grad_gb=param_bytes / BYTES_PER_GB,
        store_exec_s=0.04, sampler_exec_s=0.08, worker_exec_s=0.15,
        ps_exec_s=0.015, pmr=float(np.max(store_bytes) / np.mean(store_bytes)),
    )
    cluster = testbed_cluster()
    r = wl.realize(seed=0)
    dgtp = plan(wl, cluster, realization=r, budget=400, sim_iters=15, seed=0,
                device=device)
    dd = plan_baseline(wl, cluster, baseline="distdgl", realization=r,
                       device=device)
    print(
        f"\nplanned deployment (measured PMR "
        f"{np.max(store_bytes) / np.mean(store_bytes):.2f}): "
        f"DGTP {dgtp.schedule.makespan:.2f}s vs DistDGL {dd.schedule.makespan:.2f}s "
        f"({100 * (1 - dgtp.schedule.makespan / dd.schedule.makespan):.1f}% faster)"
    )


if __name__ == "__main__":
    main()
