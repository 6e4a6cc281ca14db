"""The port's dynamics tier against the reference's, on the CPU.

  * the traces (``constant_trace``, ``trace_from_events``,
    ``drift_trace`` at equal seeds, windows, snapshots, the drift
    measure) equal the reference's arrays;
  * ``remap_after_leave`` and ``replan_after_failure`` give the
    reference's clusters and placements;
  * the re-planning helpers and ``Replanner.replan``, ``on_leave`` and
    ``on_join`` under each shaping mode, and ``run_scenario`` for each
    strategy (budget 24, 2 intervals), give the reference's records and
    placements at ``PARITY_RTOL``; the re-planner counts into the port's
    metrics registry as the reference's does;
  * ``run_scenario(collect_traces=True)`` records the reference's traces
    and ``blame()`` equals the reference's;
    ``from_reference`` carries flows, traces, events and configs.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core as ref_core
import repro.dynamics as ref
import repro_torch.core as port_core
import repro_torch.dynamics as port
from repro.obs import REGISTRY as REF_REGISTRY
from repro_torch.convert import from_reference
from repro_torch.core import PARITY_ATOL, PARITY_RTOL
from repro_torch.obs import REGISTRY as PORT_REGISTRY

from test_golden_schedules import _jobs
from test_torch_obs import _same_blame, _same_trace as _same_schedule_trace


def _close(a, b):
    return (np.isnan(a) and np.isnan(b)) or bool(
        np.isclose(a, b, rtol=PARITY_RTOL, atol=PARITY_ATOL)
    )


def _same_trace(a, b):
    for k in ("times", "bw_in", "bw_out", "slow"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k


@pytest.fixture(scope="module")
def case():
    """The golden suite's fanin job on a 4-machine cluster."""
    wl = _jobs()[0][1]
    cluster = ref_core.heterogeneous_cluster(4, seed=3)
    p0 = ref_core.ifs_placement(wl, cluster, seed=0)
    return wl, cluster, p0


@pytest.mark.parametrize("seed", (0, 1, 7))
def test_traces_match_reference(case, seed):
    _, cluster, _ = case
    pc = from_reference(cluster)
    _same_trace(port.constant_trace(pc), ref.constant_trace(cluster))
    kw = dict(horizon_s=12.0, n_segments=5, seed=seed, bw_scale_range=(0.25, 1.0))
    a, b = port.drift_trace(pc, **kw), ref.drift_trace(cluster, **kw)
    _same_trace(a, b)
    _same_trace(from_reference(b), b)
    for t in (0.0, 2.5, 7.3, 50.0):
        assert a.segment_at(t) == b.segment_at(t)
        for x, y in zip(a.bw_at(t), b.bw_at(t)):
            assert np.array_equal(x, y)
        _same_trace(a.window(t, t + 4.0), b.window(t, t + 4.0))
        assert np.array_equal(a.snapshot_cluster(pc, t).bw_in,
                              b.snapshot_cluster(cluster, t).bw_in)
    events = [ref.DynamicsEvent(t0=1.5, t1=6.0, machine=0, bw_scale=0.4),
              ref.DynamicsEvent(t0=3.0, machine=None, bw_scale=0.75, slowdown=1.2)]
    _same_trace(port.trace_from_events(pc, [from_reference(e) for e in events]),
                ref.trace_from_events(cluster, events))
    x, y = a.bw_in[1], a.bw_in[-1]
    assert port.relative_bw_drift(x, x, y, y) == ref.relative_bw_drift(x, x, y, y)


@pytest.mark.parametrize("machine", (0, 2))
def test_leave_remap_and_replan_after_failure(case, machine):
    wl, cluster, p0 = case
    args = (from_reference(wl), from_reference(cluster), from_reference(p0), machine)
    c_ref, y_ref = ref_core.remap_after_leave(wl, cluster, p0, machine)
    c_got, y_got = port_core.remap_after_leave(*args)
    assert c_got.M == c_ref.M and np.array_equal(c_got.bw_in, c_ref.bw_in)
    assert np.array_equal(y_got.y, y_ref.y)
    kw = dict(budget=12, seed=1, sim_iters=3)
    want = ref_core.replan_after_failure(wl, cluster, p0, machine, backend="numpy", **kw)
    got = port_core.replan_after_failure(*args, device="cpu", **kw)
    assert np.array_equal(got.placement.y, want.placement.y)
    assert _close(got.best_makespan, want.best_makespan)
    assert (got.evaluations, got.accepted) == (want.evaluations, want.accepted)


def test_replan_helpers_match_reference(case):
    wl, cluster, p0 = case
    pwl, pc = from_reference(wl), from_reference(cluster)
    state = ref.default_task_state_gb(wl, cluster)
    assert np.array_equal(port.default_task_state_gb(pwl, pc), state)
    new_y = p0.y.copy()
    new_y[-3:] = (new_y[-3:] + 1) % cluster.M
    flows = ref.build_migration_flows(p0.y, new_y, state)
    got = port.build_migration_flows(p0.y, new_y, state)
    assert [dataclasses.astuple(f) for f in got] == [dataclasses.astuple(f) for f in flows]
    assert port.migration_drain_bound(pc, got) == ref.migration_drain_bound(cluster, flows)
    assert port.migration_time(pc, p0.y, new_y, state) == ref.migration_time(
        cluster, p0.y, new_y, state)
    with pytest.raises(ValueError, match="remap placements"):
        port.migration_time(pc, p0.y, np.full_like(new_y, 9), state)
    r = wl.realize(seed=0)
    clean_ref = ref_core.simulate(wl, cluster, p0, r, record=True, backend="numpy")
    clean = port_core.simulate_torch(pwl, pc, from_reference(p0), from_reference(r),
                                     record=True, device="cpu")
    want = ref.annotate_deadlines(flows, [clean_ref])
    have = port.annotate_deadlines(got, [clean])
    for f, g in zip(want, have):
        assert (f.src, f.dst, f.gb, f.task) == (g.src, g.dst, g.gb, g.task)
        assert _close(f.deadline, g.deadline)


def _same_record(a, b):
    for k in ("trigger", "replanned", "moved_tasks"):
        assert getattr(a, k) == getattr(b, k), k
    for k in ("drift", "migration_gb", "forced_gb", "migration_s", "overlap_s",
              "makespan", "objective"):
        assert _close(getattr(a, k), getattr(b, k)), (k, getattr(a, k), getattr(b, k))
    assert len(a.flows) == len(b.flows)
    for f, g in zip(a.flows, b.flows):
        assert (f.src, f.dst, f.task, f.cls) == (g.src, g.dst, g.task, g.cls)
        assert _close(f.gb, g.gb) and _close(f.deadline, g.deadline)


@pytest.mark.parametrize("shaping", (None, "strict", "deadline"))
def test_replanner_matches_reference(case, shaping):
    """A drift re-plan, a machine leave and a join, in that order, on both
    packages: the same records and incumbents after each."""
    wl, cluster, p0 = case
    cfg = ref.ReplanConfig(budget=24, sim_iters=4, shaping=shaping, backend="numpy")
    want = ref.Replanner(wl, cluster, p0.copy(), config=cfg)
    got = port.Replanner(from_reference(wl), from_reference(cluster),
                         from_reference(p0), config=from_reference(cfg, device="cpu"))
    scale = np.array([0.3, 1.0, 1.0, 0.5])
    slow = cluster.with_bandwidth(cluster.bw_in * scale, cluster.bw_out * scale)
    _same_record(want.replan(slow, trigger="drift"),
                 got.replan(from_reference(slow), trigger="drift"))
    assert np.array_equal(want.placement.y, got.placement.y)
    _same_record(want.on_leave(2), got.on_leave(2))
    assert np.array_equal(want.placement.y, got.placement.y)
    joiner = ref_core.Machine("m-join", {"mem": 48.0, "cpu": 16.0, "gpu": 2.0}, 6.25, 6.25)
    _same_record(want.on_join(joiner), got.on_join(from_reference(
        ref_core.ClusterSpec(machines=[joiner])).machines[0]))
    assert np.array_equal(want.placement.y, got.placement.y)
    assert [r.trigger for r in got.records] == ["drift", "leave", "join"]


@pytest.mark.parametrize("strategy", ("static", "replan", "oracle"))
def test_run_scenario_matches_reference(case, strategy):
    """Two intervals under a drift trace (the second sees a drift past the
    threshold, so ``replan`` re-plans and its flows ride the interval
    under deadline shaping)."""
    wl, cluster, _ = case
    trace = ref.drift_trace(cluster, horizon_s=8.0, n_segments=4, seed=1,
                            bw_scale_range=(0.25, 1.0))
    cfg = ref.ReplanConfig(budget=24, sim_iters=4, drift_threshold=0.2,
                           shaping="deadline", backend="numpy")
    kw = dict(strategy=strategy, n_intervals=2, iters_per_interval=2, seed=0,
              oracle_budget=24, oracle_chains=2)
    want = ref.run_scenario(wl, cluster, trace, replan_config=cfg, **kw)
    got = port.run_scenario(from_reference(wl), from_reference(cluster),
                            from_reference(trace),
                            replan_config=from_reference(cfg, device="cpu"), **kw)
    assert len(got.intervals) == len(want.intervals) == 2
    for a, b in zip(want.intervals, got.intervals):
        for k in ("start_s", "makespan_s", "migration_s", "overlap_s", "drift"):
            assert _close(getattr(a, k), getattr(b, k)), k
        assert a.replanned == b.replanned
    for a, b in zip(want.placements, got.placements):
        assert np.array_equal(a.y, b.y)
    assert got.shaping == want.shaping
    assert _close(got.total_s, want.total_s)
    if strategy == "replan":
        assert got.n_replans >= 1 and any(iv.flows for iv in got.intervals)


def test_replanner_counts_into_the_metrics_registry(case):
    wl, cluster, p0 = case
    cfg = ref.ReplanConfig(budget=8, sim_iters=3, backend="numpy")
    snaps = []
    for reg, rp in (
        (REF_REGISTRY, ref.Replanner(wl, cluster, p0.copy(), config=cfg)),
        (PORT_REGISTRY, port.Replanner(from_reference(wl), from_reference(cluster),
                                       from_reference(p0),
                                       config=from_reference(cfg, device="cpu"))),
    ):
        was = reg.enabled
        reg.enable()
        reg.reset()
        try:
            rp.replan(trigger="epoch")
            rp.observe(rp.cluster.bw_in, rp.cluster.bw_out)
            snaps.append(reg.snapshot())
        finally:
            reg.enabled = was
            reg.reset()
    want, got = snaps
    # the re-planner's own counters, and beneath them the search's
    # (etp.*) and the engine's (engine.simulate*), as the reference counts
    assert {k for k in want if k.startswith("replan.")} <= set(got)
    assert set(want) == set(got)
    for k in want:
        assert want[k]["kind"] == got[k]["kind"]
        if want[k]["kind"] == "counter":
            assert _close(want[k]["value"], got[k]["value"]), k


def test_unported_tiers_raise_naming_their_items(case):
    """Both tiers these raises named are ported now (the name is kept): the
    cache tier (``tests/test_torch_cache.py`` holds ``Replanner`` and
    ``run_scenario`` with it to the reference) and the observability tier:
    ``run_scenario(collect_traces=True)`` records one trace per interval,
    equal to the reference's, and ``blame()`` equals the reference's and
    conserves the run's total; without traces ``blame()`` refuses."""
    from repro_torch.cache import CacheConfig

    wl, cluster, p0 = case
    pwl, pc, pp = from_reference(wl), from_reference(cluster), from_reference(p0)
    cfg = port.ReplanConfig(device="cpu")
    budgets = CacheConfig(cache_gb=[1.0, 2.0, 3.0, 4.0])
    rp = port.Replanner(pwl, pc, pp, config=cfg, cache_config=budgets)
    assert rp.cache_config is budgets and rp.hit_model is None
    trace = ref.drift_trace(cluster, horizon_s=8.0, n_segments=4, seed=1,
                            bw_scale_range=(0.25, 1.0))
    ref_cfg = ref.ReplanConfig(budget=24, sim_iters=4, drift_threshold=0.2,
                               shaping="deadline", backend="numpy")
    kw = dict(strategy="replan", n_intervals=2, iters_per_interval=2, seed=0)
    want = ref.run_scenario(wl, cluster, trace, replan_config=ref_cfg,
                            collect_traces=True, **kw)
    got = port.run_scenario(pwl, pc, from_reference(trace),
                            replan_config=from_reference(ref_cfg, device="cpu"),
                            collect_traces=True, **kw)
    assert len(got.traces) == len(want.traces) == 2
    assert any(f.is_migration for tr in got.traces for f in tr.flows)
    for a, b in zip(want.traces, got.traces):
        _same_schedule_trace(a, b)
    _same_blame(want.blame(), got.blame())
    assert got.blame().makespan == pytest.approx(got.total_s)
    out = port.run_scenario(pwl, pc, port.constant_trace(pc), strategy="static",
                            n_intervals=1, iters_per_interval=2, replan_config=cfg)
    assert out.traces == []
    with pytest.raises(ValueError, match="collect_traces"):
        out.blame()


def test_from_reference_carries_dynamics_objects():
    f = ref_core.MigrationFlow(src=1, dst=2, gb=0.5, task=3, cls=2, deadline=4.0)
    g = from_reference(f)
    assert isinstance(g, port_core.MigrationFlow)
    assert dataclasses.astuple(g) == dataclasses.astuple(f)
    e = ref.DynamicsEvent(t0=1.0, t1=2.0, machine=1, bw_scale=0.5, slowdown=1.5)
    assert dataclasses.astuple(from_reference(e)) == dataclasses.astuple(e)
    assert isinstance(from_reference(e), port.DynamicsEvent)
    cfg = ref.ReplanConfig(budget=7, shaping="strict", backend="jax", seed=3)
    got = from_reference(cfg, device="cpu")
    assert isinstance(got, port.ReplanConfig)
    assert (got.budget, got.shaping, got.seed, got.device) == (7, "strict", 3, "cpu")
    assert from_reference(cfg).device is None
