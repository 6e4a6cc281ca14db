"""The port's arrival-driven multi-tenant service against the reference's,
on the CPU.

  * ``run_service`` on the reference tests' streams (the mixed-QoS stream
    with and without warm re-planning and under deadline shaping, the
    escalation stream with and without escalation, a hopeless arrival, a
    deferral, and ``examples/arrivals.py``'s four tenants, also with
    warm re-planning) gives the
    reference's events, epochs and SLO reports: decisions (event kinds,
    jobs, epochs' members and served counts, admissions, deadlines met)
    exactly, times at ``PARITY_RTOL`` / ``PARITY_ATOL``;
  * the isolation invariant: within the port, a rejected arrival leaves
    every admitted tenant's schedule the same, bit for bit;
  * the ordering baselines (EDF, SJF, RR, under oes and fifo) give the
    reference's reports, and the service meets strictly more deadlines
    than each on the mixed stream;
  * the solo references equal the reference's;
  * ``collect_traces`` records the reference's epoch traces and
    ``tenant_blame`` equals the reference's.
"""
import math
import re

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.dynamics as ref
import repro_torch.dynamics as port
from repro_torch.convert import from_reference
from repro_torch.core import PARITY_ATOL, PARITY_RTOL
from repro_torch.dynamics import arrivals as port_arrivals

from test_arrivals import cluster4, compute_job, mixed_stream, net_job


def _close(a, b):
    if isinstance(a, float) and not math.isfinite(a):
        return a == b or (math.isnan(a) and math.isnan(b))
    return bool(np.isclose(a, b, rtol=PARITY_RTOL, atol=PARITY_ATOL))


def _numbers_out(text):
    return re.sub(r"-?\d+(\.\d+)?", "#", text)


def _same_report(a, b):
    assert (a.n_jobs, a.n_admitted, a.deadlines_met) == (b.n_jobs, b.n_admitted,
                                                         b.deadlines_met)
    assert _close(a.mean_slowdown, b.mean_slowdown) and _close(a.fairness, b.fairness)
    for x, y in zip(a.tenants, b.tenants):
        assert (x.name, x.qos, x.admitted, x.n_defers, x.met) == (
            y.name, y.qos, y.admitted, y.n_defers, y.met)
        for k in ("t_arrive", "deadline_s", "t_admit", "t_complete",
                  "solo_makespan_s", "slowdown"):
            assert _close(getattr(x, k), getattr(y, k)), (x.name, k)


def _same_outcome(want, got):
    """Decisions exactly, times at the parity tolerance."""
    assert [(e.kind, e.job) for e in want.events] == [(e.kind, e.job) for e in got.events]
    for e, f in zip(want.events, got.events):
        assert _close(e.t, f.t)
        assert _numbers_out(e.detail) == _numbers_out(f.detail)
    assert len(want.epochs) == len(got.epochs)
    for e, f in zip(want.epochs, got.epochs):
        assert (e.reason, e.jobs, e.served, e.replanned) == (
            f.reason, f.jobs, f.served, f.replanned)
        for k in ("start_s", "end_s", "migration_gb"):
            assert _close(getattr(e, k), getattr(f, k)), k
    _same_report(want.report, got.report)


def _port_stream(stream):
    return [from_reference(a) for a in stream]


def _escalation_stream(deadline):
    return [
        ref.JobArrival("fg", 0.0, net_job(), deadline_s=1e9, qos=0),
        ref.JobArrival("bg", 0.5, net_job(), deadline_s=deadline, qos=1),
    ]


def _example_stream(cluster):
    """``examples/arrivals.py``'s four tenants."""
    hopeless = compute_job()
    solo = ref.solo_makespan(hopeless, cluster, seed=0, index=3)
    return [
        ref.JobArrival("fg", 0.0, net_job(), deadline_s=1e9, qos=0),
        ref.JobArrival("bg", 0.5, net_job(), deadline_s=42.7, qos=1),
        ref.JobArrival("doomed", 2.0, hopeless, deadline_s=2.0 + 0.5 * solo, qos=0),
        ref.JobArrival("ride", 4.0, compute_job(), deadline_s=1e9, qos=1),
    ]


def _deferral_stream(cluster):
    j0 = compute_job(n_iters=4, heavy=2.0)
    solo0 = ref.solo_makespan(j0, cluster, seed=0, index=0)
    j1 = compute_job(n_iters=4)
    solo1 = ref.solo_makespan(j1, cluster, seed=0, index=1)
    return [
        ref.JobArrival("big", 0.0, j0, deadline_s=3.0 * solo0, qos=0),
        ref.JobArrival("tight", 0.5, j1, deadline_s=0.5 + solo0 + 2.0 * solo1, qos=0),
    ]


CASES = {
    "mixed": (lambda c: mixed_stream(c), dict(replan=False)),
    "mixed_replan": (lambda c: mixed_stream(c), dict(replan=True)),
    "mixed_deadline": (lambda c: mixed_stream(c), dict(replan=False, shaping="deadline")),
    "escalate": (lambda c: _escalation_stream(42.7), dict(replan=False, escalate=True)),
    "no_escalate": (lambda c: _escalation_stream(42.7), dict(replan=False, escalate=False)),
    "hopeless": (lambda c: [
        ref.JobArrival("ok", 0.0, compute_job(), deadline_s=1e9, qos=0),
        ref.JobArrival("doomed", 1.0, compute_job(), deadline_s=2.0, qos=0),
    ], dict(replan=False)),
    "deferral": (_deferral_stream, dict(replan=False, max_defer=5, admit_margin=2.0)),
    "example": (_example_stream, dict(replan=False)),
    "example_replan": (_example_stream, dict(replan=True)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_service_matches_reference(case):
    cluster = cluster4()
    make, kw = CASES[case]
    stream = make(cluster)
    want = ref.run_service(stream, cluster, ref.ServiceConfig(**kw))
    got = port.run_service(_port_stream(stream), from_reference(cluster),
                           port.ServiceConfig(device="cpu", **kw))
    _same_outcome(want, got)
    kinds = {(e.kind, e.job) for e in got.events}
    if case == "escalate":
        assert ("escalate", "bg") in kinds and got.report.tenants[1].met
    if case == "no_escalate":
        assert not got.report.tenants[1].met
    if case in ("hopeless", "example", "example_replan"):
        assert ("reject", "doomed") in kinds and ("defer", "doomed") not in kinds


def test_service_config_carries_across():
    cfg = ref.ServiceConfig(shaping="deadline", seed=3, admit_margin=0.1, max_defer=4,
                            replan_config=ref.ReplanConfig(budget=5), escalate=False)
    got = from_reference(cfg, device="cpu")
    assert isinstance(got, port.ServiceConfig) and got.device == "cpu"
    for k in ("policy", "shaping", "seed", "admit_margin", "max_defer", "replan",
              "escalate"):
        assert getattr(got, k) == getattr(cfg, k), k
    assert got.replan_config.budget == 5 and got.replan_config.device == "cpu"
    a = from_reference(mixed_stream(cluster4())[1])
    assert isinstance(a, port.JobArrival) and (a.name, a.t_arrive, a.qos) == ("t1", 0.5, 1)


def test_rejected_arrival_never_perturbs_admitted_schedules():
    """The isolation invariant, within the port: the same stream with and
    without a rejected arrival gives the same epochs and completion
    times, bit for bit."""
    cluster = from_reference(cluster4())
    stream = _port_stream(mixed_stream(cluster4()))
    doomed = from_reference(ref.JobArrival("doomed", 0.75, compute_job(), deadline_s=1.0))
    cfg = port.ServiceConfig(replan=False, device="cpu")
    with_reject = port.run_service(stream + [doomed], cluster, cfg)
    without = port.run_service(stream, cluster, cfg)
    rejected = [t for t in with_reject.report.tenants if t.name == "doomed"][0]
    assert not rejected.admitted and rejected.slowdown == math.inf
    kept = [t for t in with_reject.report.tenants if t.name != "doomed"]
    for a, b in zip(without.report.tenants, kept):
        assert (a.name, a.t_complete, a.t_admit) == (b.name, b.t_complete, b.t_admit)
    assert [(e.start_s, e.end_s, e.jobs, e.served) for e in without.epochs] == [
        (e.start_s, e.end_s, e.jobs, e.served) for e in with_reject.epochs
    ]


@pytest.mark.parametrize("order,policy", [("edf", "oes"), ("sjf", "oes"), ("rr", "oes"),
                                          ("edf", "fifo"), ("rr", "fifo")])
def test_ordering_baselines_match_reference(order, policy):
    cluster = cluster4()
    stream = mixed_stream(cluster)
    want = ref.run_ordering_baseline(stream, cluster, order, policy=policy)
    got = port.run_ordering_baseline(_port_stream(stream), from_reference(cluster),
                                     order, policy=policy, device="cpu")
    _same_report(want, got)


def test_service_beats_every_ordering_baseline():
    """On the mixed-QoS stream the co-scheduling service meets strictly
    more deadlines than each exclusive ordering, as the reference's does."""
    cluster = from_reference(cluster4())
    stream = _port_stream(mixed_stream(cluster4()))
    svc = port.run_service(stream, cluster,
                           port.ServiceConfig(replan=False, device="cpu")).report
    assert svc.deadlines_met == 3
    for order in port.ORDERINGS:
        base = port.run_ordering_baseline(stream, cluster, order, device="cpu")
        assert svc.deadlines_met > base.deadlines_met, order
    with pytest.raises(ValueError, match="unknown order"):
        port.run_ordering_baseline(stream, cluster, "fifo", device="cpu")


def test_solo_makespans_match_reference():
    """The uncontended solo runs (IFS placement, one draw in the service's
    solo namespace): the slowdown denominators and the hopeless bound."""
    cluster = cluster4()
    pc = from_reference(cluster)
    for i, a in enumerate(_example_stream(cluster)):
        for policy in ("oes", "fifo"):
            got = port.solo_makespan(from_reference(a.workload), pc, seed=2, index=i,
                                     policy=policy, device="cpu")
            assert _close(got, ref.solo_makespan(a.workload, cluster, seed=2, index=i,
                                                 policy=policy))


def test_slo_math_and_validation_match_reference():
    for xs in ([1.0, 1.0, 1.0], [1.0, 0.0, 0.0], [], [0.3, math.inf, 2.0]):
        assert port.jain_index(xs) == ref.jain_index(xs)
    cluster = from_reference(cluster4())
    j = from_reference(compute_job())
    dup = [port.JobArrival("x", 0.0, j, deadline_s=100.0),
           port.JobArrival("x", 1.0, j, deadline_s=100.0)]
    with pytest.raises(ValueError, match="unique"):
        port.run_service(dup, cluster, port.ServiceConfig(device="cpu"))
    for k in ("SEED_NS_EPOCH", "SEED_NS_ADMIT", "SEED_NS_SOLO", "ORDERINGS"):
        assert getattr(port_arrivals, k) == getattr(ref.arrivals, k), k


def _traced_service_matches_reference(case):
    """``collect_traces=True`` on both packages: one trace a committed
    epoch, with the reference's task offsets, names and spans, and the
    reference's ``tenant_blame()``, which conserves the epochs' summed
    makespans."""
    rc = cluster4()
    cluster = from_reference(rc)
    make, kw = CASES[case]
    stream = make(rc)
    want = ref.run_service(stream, rc, ref.ServiceConfig(**kw), collect_traces=True)
    got = port.run_service(_port_stream(stream), cluster,
                           port.ServiceConfig(device="cpu", **kw), collect_traces=True)
    _same_outcome(want, got)
    assert len(got.traces) == len(got.epochs) == len(want.traces)
    for (ta, oa, na), (tb, ob, nb) in zip(want.traces, got.traces):
        assert (oa, na) == (ob, nb)
        assert _close(ta.makespan, tb.makespan)
        assert sorted((s.task, s.iter) for s in ta.tasks) == sorted(
            (s.task, s.iter) for s in tb.tasks)
        assert sorted((f.edge, f.iter, f.cls) for f in ta.flows) == sorted(
            (f.edge, f.iter, f.cls) for f in tb.flows)
    bw, bg = want.tenant_blame(), got.tenant_blame()
    assert bw.keys() == bg.keys()
    for k in bw:
        assert _close(bw[k], bg[k]), (k, bw[k], bg[k])
    total = sum(tr.makespan for tr, _, _ in got.traces)
    assert sum(bg.values()) == pytest.approx(total, rel=1e-9)
    return got


def test_traces_and_blame_raise_naming_item_6():
    """Both used to raise, naming ROADMAP Queue 1 item 6 (the name is
    kept): on the mixed stream they equal the reference's; without traces
    ``tenant_blame()`` refuses."""
    got = _traced_service_matches_reference("mixed")
    assert got.traces
    out = port.run_service(_port_stream(mixed_stream(cluster4()))[:1],
                           from_reference(cluster4()),
                           port.ServiceConfig(replan=False, device="cpu"))
    assert out.traces == []
    with pytest.raises(ValueError, match="collect_traces"):
        out.tenant_blame()


def test_tenant_blame_with_replanning_matches_reference():
    """``examples/arrivals.py``'s stream with warm re-planning: the
    service's migrations ride the traced epochs too."""
    got = _traced_service_matches_reference("example_replan")
    assert any(e.replanned for e in got.epochs)
