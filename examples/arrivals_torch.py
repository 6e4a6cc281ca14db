"""Scheduler-as-a-service walkthrough on the PyTorch port: arrival
streams and admission control.

    python3 examples/arrivals_torch.py                 # on a CUDA card
    python3 examples/arrivals_torch.py --device cpu    # on the CPU

``examples/arrivals.py`` on ``repro_torch``: an arrival stream of four
tenants goes into ``repro_torch.dynamics.run_service`` on a
heterogeneous 4-machine cluster, walking the service surface:

  * two network-heavy tenants that co-schedule (the second is admitted on
    its predicted completion, then the committed epoch schedule would miss
    its deadline — the service escalates it to class 0 for the epoch and
    audits the decision);
  * one compute-heavy tenant that joins mid-stream and rides along;
  * one hopeless arrival whose deadline is earlier than even an
    uncontended solo run could deliver — rejected outright, and (the
    isolation invariant) without perturbing any admitted tenant's
    schedule.

It closes with the per-job SLO report (deadline compliance, slowdown,
Jain fairness), the audited event log, the epoch log, and the per-tenant
critical-path blame split — which sums to each epoch's makespan at
machine precision.  Every simulation runs on ``--device``.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import build_gnn_workload, heterogeneous_cluster  # noqa: E402
from repro_torch.dynamics import (  # noqa: E402
    JobArrival,
    ServiceConfig,
    run_service,
    solo_makespan,
)


def net_job(n_iters=4, vol=2.0):
    """Network-heavy: co-scheduled copies contend on NIC bandwidth."""
    return build_gnn_workload(
        n_stores=2, n_workers=2, samplers_per_worker=2, n_ps=1,
        n_iters=n_iters, store_to_sampler_gb=vol, sampler_to_worker_gb=vol / 2,
        grad_gb=0.5, store_exec_s=0.2, sampler_exec_s=0.3,
        worker_exec_s=0.6, ps_exec_s=0.2, pmr=1.3,
    )


def compute_job(n_iters=4):
    """Compute-heavy: overlaps almost perfectly with co-tenants."""
    return build_gnn_workload(
        n_stores=2, n_workers=1, samplers_per_worker=1, n_ps=1,
        n_iters=n_iters, store_to_sampler_gb=0.2, sampler_to_worker_gb=0.1,
        grad_gb=0.05, store_exec_s=0.1, sampler_exec_s=0.2,
        worker_exec_s=2.0, ps_exec_s=0.1, pmr=1.2,
    )


def stream(cluster, device):
    """The walkthrough's four tenants (``examples/arrivals.py``'s)."""
    hopeless = compute_job()
    hopeless_solo = solo_makespan(hopeless, cluster, seed=0, index=3, device=device)
    return [
        JobArrival("fg", 0.0, net_job(), deadline_s=1e9, qos=0),
        # admitted on a ~41.8 s prediction; the committed epoch schedule
        # would land ~43.5 s -> escalated to class 0, completes ~42.6 s
        JobArrival("bg", 0.5, net_job(), deadline_s=42.7, qos=1),
        # deadline earlier than even an uncontended solo run: rejected
        JobArrival("doomed", 2.0, hopeless,
                   deadline_s=2.0 + 0.5 * hopeless_solo, qos=0),
        JobArrival("ride", 4.0, compute_job(), deadline_s=1e9, qos=1),
    ]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where every simulation runs (default: cuda)")
    args = ap.parse_args(argv)
    cluster = heterogeneous_cluster(4, seed=3, gpu_range=(2, 4))
    out = run_service(
        stream(cluster, args.device), cluster,
        ServiceConfig(replan=False, device=args.device), collect_traces=True,
    )
    print(f"device {args.device}")

    print("== audited service events ==")
    for e in out.events:
        print(f"  [{e.t:8.3f}s] {e.kind:9s} {e.job:7s} {e.detail}")

    print("\n== epoch log (cut only at admissions and completions) ==")
    for ep in out.epochs:
        served = ", ".join(f"{n}:{k}" for n, k in ep.served.items())
        print(f"  {ep.start_s:8.3f} -> {ep.end_s:8.3f}  [{ep.reason:10s}] "
              f"jobs={ep.jobs} served iters {{{served}}}")

    rep = out.report
    print("\n== per-job SLO report ==")
    print(f"  {'tenant':8s} {'admitted':>8s} {'deadline':>9s} "
          f"{'complete':>9s} {'met':>4s} {'slowdown':>9s}")
    for t in rep.tenants:
        comp = f"{t.t_complete:9.2f}" if t.admitted else "   (rej.)"
        slow = f"{t.slowdown:9.2f}" if t.admitted else "      inf"
        ddl = f"{t.deadline_s:9.2f}" if t.deadline_s < 1e8 else "   (none)"
        print(f"  {t.name:8s} {'yes' if t.admitted else 'NO':>8s} "
              f"{ddl} {comp} {'yes' if t.met else 'NO':>4s} {slow}")
    print(f"  admitted {rep.n_admitted}/{rep.n_jobs}, "
          f"deadlines met {rep.deadlines_met}, "
          f"mean slowdown {rep.mean_slowdown:.2f}, "
          f"Jain fairness {rep.fairness:.3f}")

    assert any(e.kind == "escalate" and e.job == "bg" for e in out.events)
    assert any(e.kind == "reject" and e.job == "doomed" for e in out.events)
    assert [t for t in rep.tenants if t.name == "bg"][0].met

    print("\n== per-tenant critical-path blame (sums to each epoch) ==")
    from repro_torch.obs import blame_by_tenant

    for tr, offsets, names in out.traces:
        shares = blame_by_tenant(tr, offsets)
        pretty = {("<service>" if j < 0 else names[j]): s
                  for j, s in shares.items()}
        resid = abs(sum(shares.values()) - tr.makespan)
        line = " + ".join(f"{n}={s:.2f}s" for n, s in sorted(pretty.items()))
        print(f"  makespan {tr.makespan:7.2f}s = {line}  "
              f"(residual {resid:.1e})")
        assert resid <= 1e-9 * max(1.0, tr.makespan)

    totals = out.tenant_blame()
    top = max(totals, key=totals.get)
    print(f"\n  heaviest tenant on the critical path: {top} "
          f"({totals[top]:.2f}s of blame)")
    return out


if __name__ == "__main__":
    main()
