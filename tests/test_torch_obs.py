"""The port's observability tier against the reference's, on the CPU.

  * ``ScheduleTrace.from_result`` over the torch engine equals the
    reference's over the numpy engine on ``tests/test_obs.py``'s cases
    (the golden matrix plus the strict-shaped migration variants, all
    five policies): spans compared as maps keyed by ``(task, iter)`` and
    ``(edge, iter)``, identities exactly, times at ``PARITY_RTOL`` /
    ``PARITY_ATOL``;
  * ``blame`` gives the reference's critical-path chain and components
    and conserves the makespan as ``tests/test_obs.py`` holds it; the
    NIC integrals equal the delivered bytes and the torch engine's own
    ``utilization=True`` aggregates; ``combine`` and ``blame_delta`` hold;
  * the Perfetto export round-trips and matches the reference's, and the
    validator rejects what the reference's rejects;
  * the restored ``etp.*`` and ``engine.simulate*`` counters equal the
    reference's for the same calls, and change nothing when off;
  * ``search_telemetry``, ``replan_telemetry`` and ``cache_telemetry``
    equal the reference's (except wall times);
  * ``golden_trace`` and the quickstart twin's tracing section give the
    reference's objects.
"""
import json
import math

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.obs as ref_obs
import repro_torch.obs as port_obs
from repro.core import build_gnn_workload, heterogeneous_cluster, ifs_placement, simulate
from repro.obs.blame import blame as ref_blame
from repro.obs.trace import ScheduleTrace as RefTrace
from repro_torch.convert import from_reference
from repro_torch.core import PARITY_ATOL, PARITY_RTOL, simulate_batch_torch, simulate_torch
from repro_torch.core.units import US_PER_SECOND
from repro_torch.obs.blame import COMPONENTS, blame, blame_delta, combine
from repro_torch.obs.perfetto import to_trace_events, validate_trace_events, write_trace
from repro_torch.obs.trace import ScheduleTrace

from test_golden_schedules import POLICIES, _cases

CASES = []
for _case in _cases():
    _name, _regime, *_rest = _case
    CASES.append((f"{_name}-{_regime}", *_rest))
    if _regime == "migration":
        CASES.append((f"{_name}-migration-strict", *_rest[:-1], "strict"))
CASE_IDS = [c[0] for c in CASES]


def _close(a, b):
    return bool(np.isclose(a, b, rtol=PARITY_RTOL, atol=PARITY_ATOL))


def _flows(flows):
    return None if flows is None else [from_reference(f) for f in flows]


def _traces(case, policy):
    """(reference trace over numpy, port trace over the torch engine, the
    port's result)."""
    _, wl, cluster, placement, r, tr, flows, shaping = case
    res = simulate(wl, cluster, placement, r, policy=policy, trace=tr,
                   migrations=flows, shaping=shaping, record=True, backend="numpy")
    want = RefTrace.from_result(res, wl, cluster, placement, r, trace=tr,
                                migrations=flows, shaping=shaping)
    pwl, pc, pp, pr = (from_reference(x) for x in (wl, cluster, placement, r))
    ptr = None if tr is None else from_reference(tr)
    pflows = _flows(flows)
    got_res = simulate_torch(pwl, pc, pp, pr, policy=policy, trace=ptr,
                             migrations=pflows, shaping=shaping, record=True,
                             device="cpu")
    got = ScheduleTrace.from_result(got_res, pwl, pc, pp, pr, trace=ptr,
                                    migrations=pflows, shaping=shaping)
    return want, got, got_res


def _same_trace(a, b):
    assert (a.M, a.policy, a.shaping, a.machine_names) == (
        b.M, b.policy, b.shaping, b.machine_names)
    assert _close(a.makespan, b.makespan)
    ta = {(s.task, s.iter): s for s in a.tasks}
    tb = {(s.task, s.iter): s for s in b.tasks}
    assert ta.keys() == tb.keys() and len(ta) == len(b.tasks)
    for k, s in ta.items():
        t = tb[k]
        assert (s.machine, s.kind, s.name) == (t.machine, t.kind, t.name), k
        for f in ("start", "end", "nominal_s"):
            assert _close(getattr(s, f), getattr(t, f)), (k, f)
    fa = {(f.edge, f.iter): f for f in a.flows}
    fb = {(f.edge, f.iter): f for f in b.flows}
    assert fa.keys() == fb.keys() and len(fa) == len(b.flows)
    for k, f in fa.items():
        g = fb[k]
        assert (f.src, f.dst, f.cls, f.name, f.gated_task, f.is_migration) == (
            g.src, g.dst, g.cls, g.name, g.gated_task, g.is_migration), k
        for x in ("start", "end", "gb", "ideal_s", "deadline"):
            assert _close(getattr(f, x), getattr(g, x)), (k, x)


def _chain(rep):
    """A report's critical path as keys (either package's spans)."""
    return [("task", s.task, s.iter) if hasattr(s, "task") else
            ("flow", s.edge, s.iter) for s in rep.path]


def _same_blame(a, b):
    """The same chain, and components at the parity tolerance of the
    makespan they split."""
    tol = PARITY_RTOL * max(1.0, a.makespan) + PARITY_ATOL
    assert _close(a.makespan, b.makespan)
    assert list(a.components) == list(b.components) == list(COMPONENTS)
    for k in COMPONENTS:
        assert abs(a.components[k] - b.components[k]) <= tol, (
            k, a.components[k], b.components[k])
    assert a.per_machine_contention.keys() == b.per_machine_contention.keys()
    for m, v in a.per_machine_contention.items():
        assert abs(v - b.per_machine_contention[m]) <= tol, m


# ---------------------------------------------------------------------------
# traces, blame, conservation
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_trace_and_blame_match_reference(case, policy):
    want, got, _ = _traces(case, policy)
    _same_trace(want, got)
    rw, rg = ref_blame(want), blame(got)
    assert _chain(rw) == _chain(rg), case[0]
    _same_blame(rw, rg)
    # conservation, as tests/test_obs.py holds the reference
    assert abs(rg.residual) < 1e-9 * max(1.0, got.makespan), rg.components
    for a, b in zip(rg.path, rg.path[1:]):
        assert b.start >= a.start - 1e-9
    for m in range(got.M):
        for direction in ("in", "out"):
            assert math.isclose(got.utilization_integral(m, direction),
                                got.delivered_gb(m, direction),
                                rel_tol=1e-9, abs_tol=1e-9)
    assert _close(rg.critical_path_length, rw.critical_path_length)


@pytest.mark.parametrize("case", CASES[:4] + [c for c in CASES if c[7] is not None][:3],
                         ids=CASE_IDS[:4] + [c[0] for c in CASES if c[7] is not None][:3])
def test_trace_aggregates_match_engine_utilization(case):
    """The trace's NIC integrals, busy time and class bytes equal the torch
    engine's own ``utilization=True`` aggregates of the same run (the
    counterpart of tests/test_obs.py's JAX check)."""
    _, wl, cluster, placement, r, tr, flows, shaping = case
    for policy in ("oes", "fifo"):
        _, got, _ = _traces(case, policy)
        res = simulate_torch(from_reference(wl), from_reference(cluster),
                             from_reference(placement), from_reference(r),
                             policy=policy,
                             trace=None if tr is None else from_reference(tr),
                             migrations=_flows(flows), shaping=shaping,
                             utilization=True, device="cpu")
        agg, ref = res.aggregates, got.aggregates()
        for k in ("nic_in_gb", "nic_out_gb"):
            np.testing.assert_allclose(agg[k], ref[k], rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(agg["busy_s"], ref["busy_s"], rtol=1e-6, atol=1e-6)
        for cls_id, gb in ref["class_gb"].items():
            assert agg["class_gb"][cls_id] == pytest.approx(gb, rel=1e-9)


def test_combine_and_blame_delta_match_reference():
    pairs = [_traces(c, "oes") for c in CASES[:3]]
    want = ref_obs.combine([ref_blame(w) for w, _, _ in pairs])
    got = combine([blame(g) for _, g, _ in pairs])
    _same_blame(want, got)
    assert math.isclose(got.makespan, sum(g.makespan for _, g, _ in pairs))
    assert abs(got.residual) < 1e-9 * max(1.0, got.makespan)
    a, b = blame(pairs[0][1]), blame(pairs[1][1])
    table = blame_delta(a, b, "a", "b")
    assert "makespan" in table and "contention" in table
    ra, rb = ref_blame(pairs[0][0]), ref_blame(pairs[1][0])
    assert table == ref_obs.blame_delta(ra, rb, "a", "b")
    assert a.table("x") == ra.table("x")


def test_flow_log_none_when_unrecorded():
    name, wl, cluster, placement, r, tr, flows, shaping = CASES[0]
    pwl, pc, pp, pr = (from_reference(x) for x in (wl, cluster, placement, r))
    res = simulate_torch(pwl, pc, pp, pr, record=False, device="cpu")
    assert res.flow_log is None
    with pytest.raises(ValueError, match="record=True"):
        ScheduleTrace.from_result(res, pwl, pc, pp, pr)
    rec = simulate_torch(pwl, pc, pp, pr, record=True, device="cpu")
    assert len(rec.flow_log) > 0
    batch = simulate_batch_torch(pwl, pc, [pp, pp], [pr, pr], record=True,
                                 device="cpu")
    for one in batch:
        assert len(ScheduleTrace.from_result(one, pwl, pc, pp, pr).flows) == len(
            rec.flow_log)


# ---------------------------------------------------------------------------
# Perfetto export
# ---------------------------------------------------------------------------
def test_perfetto_roundtrip_matches_reference(tmp_path):
    want, got, _ = _traces(CASES[0], "oes")
    path = tmp_path / "trace.json"
    obj = write_trace(got, path)
    loaded = json.loads(path.read_text())
    counts = validate_trace_events(loaded)
    assert counts == validate_trace_events(obj)
    assert counts == ref_obs.validate_trace_events(ref_obs.to_trace_events(want))
    assert counts["X"] == len(got.tasks) + len(got.flows)
    assert counts["M"] == 3 * got.M
    assert counts["C"] > 0
    assert loaded["otherData"]["makespan_s"] == pytest.approx(got.makespan)
    for e in loaded["traceEvents"]:
        if e["ph"] == "X":
            assert e["ts"] + e["dur"] <= got.makespan * US_PER_SECOND + 1e-3
    ref_ev = ref_obs.to_trace_events(want)["traceEvents"]
    got_ev = to_trace_events(got)["traceEvents"]
    key = lambda e: (e["ph"], e["pid"], e.get("tid", 0), e["name"])  # noqa: E731
    assert sorted(map(key, ref_ev)) == sorted(map(key, got_ev))


@pytest.mark.parametrize("bad,match", [
    ({}, "traceEvents"),
    ({"traceEvents": [{"ph": "B", "pid": 0, "name": "x"}]}, "phase"),
    ({"traceEvents": [{"ph": "X", "pid": 0, "tid": 1, "name": "x", "ts": 0.0,
                       "dur": -1.0}]}, "dur"),
    ({"traceEvents": [{"ph": "M", "pid": 0, "name": "nope", "args": {}}]}, "metadata"),
    ({"traceEvents": [{"ph": "C", "pid": 0, "name": "c", "ts": 1.0, "args": {}}]},
     "counter"),
    ([], "JSON object"),
])
def test_perfetto_validator_rejects_malformed(bad, match):
    with pytest.raises(ValueError, match=match):
        validate_trace_events(bad)
    with pytest.raises(ValueError, match=match):
        ref_obs.validate_trace_events(bad)


# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------
def _tiny_job():
    wl = build_gnn_workload(
        n_stores=2, n_workers=2, samplers_per_worker=1, n_ps=1, n_iters=6,
        store_to_sampler_gb=0.8, sampler_to_worker_gb=0.4, grad_gb=0.25,
        store_exec_s=0.3, sampler_exec_s=0.4, worker_exec_s=0.8,
        ps_exec_s=0.2, pmr=1.3,
    )
    return wl, heterogeneous_cluster(3, seed=1)


def _counted(reg, fn):
    was = reg.enabled
    reg.enable()
    reg.reset()
    try:
        out = fn()
        return out, reg.snapshot()
    finally:
        reg.enabled = was
        reg.reset()


def test_search_counters_match_reference():
    """The same ``etp_multichain`` call counts the same ``etp.*`` and
    ``engine.*`` values in both packages; off, it gives the same search."""
    from repro.core.placement import etp_multichain as ref_etp
    from repro_torch.core import etp_multichain

    wl, cluster = _tiny_job()
    kw = dict(n_chains=2, budget=30, seed=0, sim_iters=3)
    want, snap_ref = _counted(ref_obs.REGISTRY,
                              lambda: ref_etp(wl, cluster, backend="numpy", **kw))
    pwl, pc = from_reference(wl), from_reference(cluster)
    got, snap = _counted(port_obs.REGISTRY,
                         lambda: etp_multichain(pwl, pc, device="cpu", **kw))
    assert set(snap) == set(snap_ref)
    assert {"etp.evaluations", "etp.cache_hits", "etp.proposals", "etp.accepted",
            "engine.simulate_batch.calls", "engine.simulate_batch.instances"} <= set(snap)
    for k, v in snap_ref.items():
        assert snap[k] == v, k
    assert snap["etp.evaluations"]["value"] == sum(c["evaluations"] for c in got.chain_stats)
    assert not port_obs.REGISTRY.enabled and port_obs.REGISTRY.snapshot() == {}
    off = etp_multichain(pwl, pc, device="cpu", **kw)
    assert np.array_equal(off.placement.y, got.placement.y)
    assert off.best_makespan == got.best_makespan
    assert np.array_equal(got.placement.y, want.placement.y)


def test_engine_counters_once_per_public_call():
    """``simulate_torch`` counts ``engine.simulate.calls`` only, though it
    runs the batch program; ``simulate_batch_torch`` counts one call and
    its instances; the schedule is the same with the registry off."""
    name, wl, cluster, placement, r, tr, flows, shaping = CASES[0]
    pwl, pc, pp, pr = (from_reference(x) for x in (wl, cluster, placement, r))
    on, snap = _counted(port_obs.REGISTRY,
                        lambda: simulate_torch(pwl, pc, pp, pr, device="cpu"))
    _, snap_ref = _counted(ref_obs.REGISTRY,
                           lambda: simulate(wl, cluster, placement, r, backend="numpy"))
    assert snap == snap_ref == {"engine.simulate.calls": {"kind": "counter", "value": 1.0}}
    _, snap = _counted(port_obs.REGISTRY, lambda: simulate_batch_torch(
        pwl, pc, [pp] * 3, [pr] * 3, device="cpu"))
    assert snap == {"engine.simulate_batch.calls": {"kind": "counter", "value": 1.0},
                    "engine.simulate_batch.instances": {"kind": "counter", "value": 3.0}}
    off = simulate_torch(pwl, pc, pp, pr, device="cpu")
    assert on.makespan == off.makespan


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------
def test_search_telemetry_matches_reference():
    from repro.core.placement import etp_multichain as ref_etp
    from repro.obs.telemetry import search_telemetry as ref_tel
    from repro_torch.core import etp_multichain
    from repro_torch.obs.telemetry import search_telemetry

    wl, cluster = _tiny_job()
    kw = dict(n_chains=2, budget=30, seed=0, sim_iters=3)
    want = ref_tel(ref_etp(wl, cluster, backend="numpy", **kw))
    got = search_telemetry(etp_multichain(from_reference(wl), from_reference(cluster),
                                          device="cpu", **kw))
    assert got["proposals"] >= got["accepted"] >= 0 and len(got["chains"]) == 2
    _same_telemetry(want, got)


def _same_telemetry(want, got):
    """Equal dicts, except wall times; floats at the parity tolerance."""
    if isinstance(want, dict):
        assert set(want) == set(got)
        for k in want:
            if k != "wall_time_s":
                _same_telemetry(want[k], got[k])
    elif isinstance(want, list):
        assert len(want) == len(got)
        for a, b in zip(want, got):
            _same_telemetry(a, b)
    elif isinstance(want, float):
        assert _close(want, got) or (math.isnan(want) and math.isnan(got)), (want, got)
    else:
        assert want == got


def test_replan_telemetry_matches_reference():
    import repro.dynamics as ref_dyn
    import repro_torch.dynamics as port_dyn
    from repro.obs.telemetry import replan_telemetry as ref_tel
    from repro_torch.obs.telemetry import replan_telemetry

    wl, cluster = _tiny_job()
    p0 = ifs_placement(wl, cluster, seed=0)
    cfg = ref_dyn.ReplanConfig(budget=12, sim_iters=3, backend="numpy")
    want = ref_dyn.Replanner(wl, cluster, p0.copy(), config=cfg)
    got = port_dyn.Replanner(from_reference(wl), from_reference(cluster),
                             from_reference(p0), config=from_reference(cfg, device="cpu"))
    for rp in (want, got):
        rp.replan(trigger="epoch")
        rp.observe(rp.cluster.bw_in, rp.cluster.bw_out)
        rp.on_leave(1)
    rows = replan_telemetry(got.records)
    assert len(rows) == 3 and rows[-1]["trigger"] == "leave" and "search" in rows[-1]
    _same_telemetry(ref_tel(want.records), rows)


def test_cache_telemetry_matches_reference():
    from repro.cache.policies import replay as ref_replay
    from repro.cache.trace import AccessTrace
    from repro.obs.telemetry import cache_telemetry as ref_cache
    from repro_torch.cache.policies import replay
    from repro_torch.obs.telemetry import cache_telemetry, snapshot

    rng = np.random.default_rng(0)
    accesses = [[rng.integers(0, 50, size=30) for _ in range(4)] for _ in range(2)]
    tr = AccessTrace(accesses=accesses, n_nodes=50, bytes_per_node=1024)
    ptr = from_reference(tr)
    want, _ = _counted(ref_obs.REGISTRY, lambda: (
        ref_replay(tr, "lru", capacity_nodes=20, k=2), ref_cache()))
    got, snap = _counted(port_obs.REGISTRY, lambda: (
        cache_telemetry(), replay(ptr, "lru", capacity_nodes=20, k=2),
        cache_telemetry(), snapshot()))
    assert got[0] is None
    assert got[2] == want[1] and got[3] == snap
    assert cache_telemetry() is None  # the registry is off again


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------
def test_lazy_exports_match_reference():
    """The reference's lazy export table; each name resolves to the
    function or class, also ``blame`` once its submodule was imported
    (this file imports ``repro_torch.obs.blame`` at the top)."""
    import types

    assert port_obs.__all__ == ref_obs.__all__ and port_obs._LAZY == ref_obs._LAZY
    for name, (mod, attr) in port_obs._LAZY.items():
        value = getattr(port_obs, name)
        assert not isinstance(value, types.ModuleType), name
        assert value.__name__ == attr and value.__module__ == f"repro_torch.obs.{mod}"
    assert port_obs.blame is blame
    with pytest.raises(AttributeError):
        port_obs.no_such_name  # noqa: B018


@pytest.mark.parametrize("policy", ("oes", "fifo"))
def test_golden_trace_matches_reference(policy, tmp_path, capsys):
    from repro.obs.smoke import golden_trace as ref_golden
    from repro_torch.obs.smoke import golden_trace, main

    want, got = ref_golden(policy), golden_trace(policy, device="cpu")
    _same_trace(want, got)
    _same_blame(ref_blame(want), blame(got))
    out = tmp_path / "trace.json"
    main(["--device", "cpu", "--policy", policy, "--out", str(out)])
    printed = capsys.readouterr().out
    assert ref_blame(want).table(f"golden fan-in ({policy})") in printed
    validate_trace_events(json.loads(out.read_text()))
    with pytest.raises(RuntimeError, match="cuda"):
        golden_trace(policy)  # no card here, and no fallback


def test_quickstart_tracing_section_matches_reference(tmp_path, capsys):
    """The quickstart twin at a small budget against the reference's plan,
    baselines and trace at the same budget."""
    import importlib.util
    from pathlib import Path

    from repro.core import plan as ref_plan, plan_baseline as ref_baseline, testbed_cluster
    from repro.core.profiles import OGBN_PRODUCTS, build_workload_from_profile

    path = Path(__file__).resolve().parents[1] / "examples" / "quickstart_torch.py"
    spec = importlib.util.spec_from_file_location("quickstart_torch", path)
    qs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(qs)
    budget = 8
    out = tmp_path / "trace.json"
    p, dd, tr, rep = qs.main(["--device", "cpu", "--budget", str(budget), "--out", str(out)])
    printed = capsys.readouterr().out
    assert "== tracing the winning schedule (repro_torch.obs) ==" in printed

    wl = build_workload_from_profile(OGBN_PRODUCTS, n_stores=4, n_workers=6,
                                     samplers_per_worker=2, n_ps=1, n_iters=40)
    cluster = testbed_cluster()
    r = wl.realize(seed=0)
    want = ref_plan(wl, cluster, realization=r, budget=budget, sim_iters=15, seed=0,
                    backend="numpy")
    assert np.array_equal(p.placement.y, want.placement.y)
    assert _close(p.schedule.makespan, want.schedule.makespan)
    assert p.delta == want.delta and p.certificate.holds == want.certificate.holds
    assert _close(dd.schedule.makespan,
                  ref_baseline(wl, cluster, baseline="distdgl",
                               realization=r).schedule.makespan)
    res = simulate(wl, cluster, want.placement, r, record=True, backend="numpy")
    ref_tr = RefTrace.from_result(res, wl, cluster, want.placement, r)
    _same_trace(ref_tr, tr)
    _same_blame(ref_blame(ref_tr), rep)
    assert rep.table(label="  oes") in printed
    counts = validate_trace_events(json.loads(out.read_text()))
    assert counts["X"] == len(tr.tasks) + len(tr.flows)
