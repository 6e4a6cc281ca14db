"""The port's feature-cache tier against the reference's, on the CPU.

  * the access trace (the port's sampler replayed), the three replays,
    the hit tables (warm views, the tail past the trace, the k clamp and
    its warning), the estimators and the GB bridge, the profile proxy
    trace, the reservations and the rewritten volumes give the
    reference's values exactly;
  * ``cache_cost_fns``, ``cache_aware_etp`` (the same placement) and
    ``cache_aware_plan`` match at ``PARITY_RTOL`` / ``PARITY_ATOL``;
  * ``Replanner`` with ``hit_model`` and ``cache_config`` (a drift
    re-plan, ``on_leave`` and ``on_join`` with per-machine budgets) and
    ``run_scenario`` with both, for each strategy, give the reference's
    records, placements and budgets.
"""
import contextlib

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.cache as ref
import repro.core as ref_core
import repro.dynamics as ref_dyn
import repro_torch.cache as port
import repro_torch.core as port_core
import repro_torch.dynamics as port_dyn
from repro.data.graph import synthetic_graph as ref_graph
from repro_torch.convert import from_reference
from repro_torch.core import PARITY_ATOL, PARITY_RTOL
from repro_torch.data.graph import synthetic_graph as port_graph

from test_cache import skewed_job
from test_golden_schedules import _jobs

CAPACITIES = (0, 50, 200, 800, 2000)
GRAPH = dict(n_nodes=2000, avg_degree=12, n_feats=16, n_parts=4, seed=0)
TRACE = dict(n_samplers=8, seeds_per_iter=16, fanouts=(4, 4), n_iters=12, seed=0)


def _close(a, b):
    return bool(np.allclose(a, b, rtol=PARITY_RTOL, atol=PARITY_ATOL))


@pytest.fixture(scope="module")
def traces():
    """The reference's trace and the port's, each from its own sampler."""
    return (ref.collect_trace(ref_graph(**GRAPH), **TRACE),
            port.collect_trace(port_graph(**GRAPH), **TRACE))


@pytest.fixture(scope="module")
def paper_job():
    return ref_core.build_workload_from_profile(
        ref_core.OGBN_PRODUCTS, n_stores=4, n_workers=6, samplers_per_worker=2,
        n_ps=1, n_iters=8,
    )


def _same_trace(a, b):
    assert (a.n_samplers, a.n_iters, a.n_nodes, a.bytes_per_node) == (
        b.n_samplers, b.n_iters, b.n_nodes, b.bytes_per_node)
    for x, y in zip(a.accesses, b.accesses):
        assert len(x) == len(y)
        for u, v in zip(x, y):
            assert np.array_equal(u, v)


def test_trace_equals_reference(traces):
    want, got = traces
    _same_trace(want, got)
    for k in (1, 3, 8):
        assert np.array_equal(want.touch_counts(k), got.touch_counts(k))
    _same_trace(want, from_reference(want))


@pytest.mark.parametrize("policy", ("static", "lru", "prefetch"))
def test_replays_equal_reference(traces, policy):
    want, got = traces
    for cap in CAPACITIES:
        for k in (1, 2, 4):
            assert np.array_equal(port.replay(got, policy, cap, k),
                                  ref.replay(want, policy, cap, k)), (cap, k)
    assert sorted(port.REPLAYS) == sorted(ref.REPLAYS)
    with pytest.raises(ValueError, match="unknown cache policy"):
        port.replay(got, "fifo", 10)
    with pytest.raises(ValueError, match="sharing degree"):
        port.replay(got, policy, 10, k=0)


@pytest.mark.parametrize("policy", ("lru", "prefetch"))
def test_hit_model_equals_reference(traces, policy):
    """The hit tables, their tail past the trace, warm views, and the
    clamp (with its warning) when more samplers share a cache than the
    trace recorded."""
    want_t, got_t = traces
    want = ref.build_hit_model(want_t, policy=policy, capacity_nodes=300)
    got = port.build_hit_model(got_t, policy=policy, capacity_nodes=300)
    for k in (1, 2, 5):
        for n in (4, 12, 40):
            assert np.array_equal(got.hit_rates(k, n), want.hit_rates(k, n))
    for extra in (0, 3, 20):
        assert np.array_equal(got.warm_started(extra).hit_rates(2, 10),
                              want.warm_started(extra).hit_rates(2, 10))
    assert got.mean_hit_rate(2) == want.mean_hit_rate(2)
    with pytest.warns(UserWarning, match="exceeds the trace's 8 samplers"):
        clamped = got.hit_rates(11, 6)
    with pytest.warns(UserWarning):
        assert np.array_equal(clamped, want.hit_rates(11, 6))
    with pytest.raises(ValueError, match="extra_iters"):
        got.warm_started(-1)
    carried = from_reference(want.warm_started(5))
    assert (carried.warm_iters, carried.capacity_nodes, carried.policy) == (5, 300, policy)
    assert np.array_equal(carried.hit_rates(2, 9), want.warm_started(5).hit_rates(2, 9))


def test_estimators_equal_reference(traces):
    want, got = traces
    for k in (1, 2, 4):
        assert np.array_equal(port.touch_probabilities(got, k),
                              ref.touch_probabilities(want, k))
        for cap in CAPACITIES:
            assert port.static_hit_rate_estimate(got, cap, k) == \
                ref.static_hit_rate_estimate(want, cap, k)
    kw = dict(bytes_per_node=400, real_nodes=2.4e6, proxy_nodes=6000)
    for gb in (0.05, 0.2, 0.5, 40.0):
        cap = port.capacity_nodes_for_gb(gb, **kw)
        assert cap == ref.capacity_nodes_for_gb(gb, **kw)
        assert port.cache_gb_for_capacity(cap, **kw) == ref.cache_gb_for_capacity(cap, **kw)
    assert port.cache_gb_for_capacity(1000, bytes_per_node=400) == \
        ref.cache_gb_for_capacity(1000, bytes_per_node=400)
    with pytest.raises(ValueError, match="neither"):
        port.cache_gb_for_capacity(10, bytes_per_node=4, real_nodes=1.0)


def test_profile_hit_model_equals_reference():
    """The ogbn-products proxy: a size-scaled synthetic graph with the
    profile's fan-outs, its trace, and the GB budget in proxy nodes."""
    kw = dict(n_samplers=4, n_iters=5, proxy_nodes=1500)
    want_t = ref.collect_profile_trace(ref_core.OGBN_PRODUCTS, **kw)
    got_t = port.collect_profile_trace(port_core.OGBN_PRODUCTS, **kw)
    _same_trace(want_t, got_t)
    for policy, gb in (("lru", 0.2), ("static", 1.0)):
        want = ref.hit_model_for_profile(ref_core.OGBN_PRODUCTS, cache_gb=gb,
                                         policy=policy, trace=want_t, **kw)
        got = port.hit_model_for_profile(port_core.OGBN_PRODUCTS, cache_gb=gb,
                                         policy=policy, trace=got_t, **kw)
        assert got.capacity_nodes == want.capacity_nodes > 0
        assert np.array_equal(got.hit_rates(2, 8), want.hit_rates(2, 8))
    got = port.hit_model_for_profile(port_core.OGBN_PRODUCTS, cache_gb=0.2, **kw)
    _same_trace(want_t, got.trace)


def _sampler_placements(wl, cluster):
    spread = ref_core.ifs_placement(wl, cluster, seed=0)
    stacked = spread.copy()
    samplers = [j for j, t in enumerate(wl.tasks) if t.kind == "sampler"]
    stacked.y[samplers] = 0
    pair = spread.copy()
    pair.y[samplers[:2]] = 1
    return [spread, stacked, pair]


def test_rewritten_volumes_equal_reference(traces, paper_job):
    """The placement-dependent rewrite (one shared model, and per-machine
    models), the index helpers and the budget vector."""
    want_t, got_t = traces
    wl, cluster = paper_job, ref_core.testbed_cluster()
    pwl, pc = from_reference(wl), from_reference(cluster)
    assert np.array_equal(port.sampler_ids(pwl), ref.sampler_ids(wl))
    assert np.array_equal(port.g2s_edge_ids(pwl), ref.g2s_edge_ids(wl))
    r = wl.realize(seed=0)
    want_m = ref.build_hit_model(want_t, policy="lru", capacity_nodes=600)
    got_m = port.build_hit_model(got_t, policy="lru", capacity_nodes=600)
    small = dict(policy="lru", capacity_nodes=100)
    want_rw = ref.CacheRewriter(wl, cluster, want_m,
                                machine_models={2: ref.build_hit_model(want_t, **small)})
    got_rw = port.CacheRewriter(pwl, pc, got_m,
                                machine_models={2: port.build_hit_model(got_t, **small)})
    for p in _sampler_placements(wl, cluster):
        pp = from_reference(p)
        assert np.array_equal(port.samplers_per_machine(pwl, pc, pp),
                              ref.samplers_per_machine(wl, cluster, p))
        with _maybe_warns(p, wl):
            a = ref.cache_adjusted_realization(wl, cluster, p, r, want_m)
        with _maybe_warns(p, wl):
            b = port.cache_adjusted_realization(pwl, pc, pp, from_reference(r), got_m)
        assert np.array_equal(a.volumes, b.volumes)
        assert np.array_equal(a.exec_times, b.exec_times)
        with _maybe_warns(p, wl):
            a = want_rw.adjust(p, r)
        with _maybe_warns(p, wl):
            b = got_rw.adjust(pp, from_reference(r))
        assert np.array_equal(a.volumes, b.volumes)
    for gb in (1.5, [1.0, 2.0, 0.5, 0.0]):
        assert np.array_equal(port.CacheConfig(cache_gb=gb).cache_gb_per_machine(4),
                              ref.CacheConfig(cache_gb=gb).cache_gb_per_machine(4))
    with pytest.raises(ValueError, match="length-4"):
        port.CacheConfig(cache_gb=[1.0, 2.0]).cache_gb_per_machine(4)


def _maybe_warns(p, wl):
    """The k clamp warns when a machine hosts more samplers than the
    trace's 8 (the stacked placement puts all 12 on machine 0)."""
    samplers = [j for j, t in enumerate(wl.tasks) if t.kind == "sampler"]
    if np.bincount(p.y[samplers]).max() > 8:
        return pytest.warns(UserWarning, match="clamping")
    return contextlib.nullcontext()


def test_reservations_equal_reference(paper_job):
    wl, cluster = paper_job, ref_core.testbed_cluster()
    pwl, pc = from_reference(wl), from_reference(cluster)
    for p in _sampler_placements(wl, cluster):
        for cfg in (ref.CacheConfig(cache_gb=8.0, reserve_mem=False),
                    ref.CacheConfig(cache_gb=1.0), ref.CacheConfig(cache_gb=64.0),
                    ref.CacheConfig(cache_gb=[30.0, 0.0, 8.0, 2.0])):
            assert port.cache_reservation_violation(
                pwl, pc, from_reference(cfg), from_reference(p)
            ) == ref.cache_reservation_violation(wl, cluster, cfg, p)


@pytest.mark.parametrize("policy", ("oes", "fifo"))
def test_cache_cost_fns_match_reference(traces, policy):
    """The scalar and batched cache-adjusted objectives, and their shared
    draws, under OES and under DistDGL's fifo (waterfill's rates)."""
    want_t, got_t = traces
    wl, cluster = skewed_job(), ref_core.testbed_cluster()
    kw = dict(sim_iters=6, sim_draws=2, seed=5, policy=policy)
    want_m = ref.build_hit_model(want_t, policy="prefetch", capacity_nodes=150)
    got_m = port.build_hit_model(got_t, policy="prefetch", capacity_nodes=150)
    w_scalar, w_batch, w_draws = ref.cache_cost_fns(wl, cluster, want_m, **kw)
    g_scalar, g_batch, g_draws = port.cache_cost_fns(
        from_reference(wl), from_reference(cluster), got_m, device="cpu", **kw)
    for a, b in zip(w_draws, g_draws):
        assert np.array_equal(a.volumes, b.volumes)
    ps = _sampler_placements(wl, cluster)
    assert _close(g_batch([from_reference(p) for p in ps]), w_batch(ps))
    assert _close(g_scalar(from_reference(ps[1])), w_scalar(ps[1]))


def test_cache_aware_etp_matches_reference(traces):
    """Cache-aware multi-chain ETP on the skewed testbed job: the same
    winner, best cost and evaluations as the reference's."""
    want_t, got_t = traces
    wl, cluster = skewed_job(), ref_core.testbed_cluster()
    kw = dict(n_chains=4, budget=32, sim_iters=6, seed=0)
    want = ref.cache_aware_etp(
        wl, cluster, ref.build_hit_model(want_t, policy="prefetch", capacity_nodes=150),
        ref.CacheConfig(policy="prefetch", cache_gb=1.0), **kw)
    got = port.cache_aware_etp(
        from_reference(wl), from_reference(cluster),
        port.build_hit_model(got_t, policy="prefetch", capacity_nodes=150),
        port.CacheConfig(policy="prefetch", cache_gb=1.0), device="cpu", **kw)
    assert np.array_equal(want.placement.y, got.placement.y)
    assert _close(got.best_makespan, want.best_makespan)
    assert (got.evaluations, got.fallback) == (want.evaluations, want.fallback)


def test_cache_aware_etp_reservation_matches_reference(traces, paper_job):
    """An 8 GB reservation on 48 GB machines binds: the search must spread
    the samplers, and its winner carries no reservation bill."""
    want_t, got_t = traces
    wl, cluster = paper_job, ref_core.testbed_cluster()
    cfg = ref.CacheConfig(policy="lru", cache_gb=8.0)
    kw = dict(n_chains=2, budget=12, sim_iters=4, seed=0)
    want = ref.cache_aware_etp(
        wl, cluster, ref.build_hit_model(want_t, policy="lru", capacity_nodes=300),
        cfg, **kw)
    got = port.cache_aware_etp(
        from_reference(wl), from_reference(cluster),
        port.build_hit_model(got_t, policy="lru", capacity_nodes=300),
        from_reference(cfg), device="cpu", **kw)
    assert np.array_equal(want.placement.y, got.placement.y)
    assert _close(got.best_makespan, want.best_makespan)
    assert got.fallback == want.fallback
    assert port.cache_reservation_violation(
        from_reference(wl), from_reference(cluster), from_reference(cfg), got.placement
    ) == ref.cache_reservation_violation(wl, cluster, cfg, want.placement)


def test_cache_aware_plan_matches_reference(traces):
    want_t, got_t = traces
    wl, cluster = skewed_job(), ref_core.testbed_cluster()
    kw = dict(n_chains=2, budget=8, sim_iters=4, seed=0)
    want = ref.cache_aware_plan(
        wl, cluster, ref.build_hit_model(want_t, policy="lru", capacity_nodes=600),
        ref.CacheConfig(policy="lru", cache_gb=1.0), **kw)
    got = port.cache_aware_plan(
        from_reference(wl), from_reference(cluster),
        port.build_hit_model(got_t, policy="lru", capacity_nodes=600),
        port.CacheConfig(policy="lru", cache_gb=1.0), device="cpu", **kw)
    assert np.array_equal(want.placement.y, got.placement.y)
    assert np.array_equal(want.adjusted.volumes, got.adjusted.volumes)
    assert _close(got.schedule.makespan, want.schedule.makespan)
    assert _close(got.uncached_makespan, want.uncached_makespan)
    assert len(got.schedule.flow_log) == len(want.schedule.flow_log)
    assert got.config == port.CacheConfig(policy="lru", cache_gb=1.0)
    model = port.build_hit_model(got_t, policy="lru", capacity_nodes=10)
    for fn in (port.cache_aware_etp, port.cache_aware_plan):
        with pytest.raises(ValueError, match="disagrees"):
            fn(from_reference(wl), from_reference(cluster), model,
               port.CacheConfig(policy="static"), device="cpu")


def _same_record(a, b):
    for k in ("trigger", "replanned", "moved_tasks"):
        assert getattr(a, k) == getattr(b, k), k
    for k in ("drift", "migration_gb", "forced_gb", "migration_s", "overlap_s",
              "makespan", "objective"):
        x, y = getattr(a, k), getattr(b, k)
        assert (np.isnan(x) and np.isnan(y)) or _close(x, y), (k, x, y)
    assert [(f.src, f.dst, f.task, f.cls) for f in a.flows] == [
        (f.src, f.dst, f.task, f.cls) for f in b.flows]


@pytest.fixture(scope="module")
def fanin():
    """The golden suite's fanin job (two workers of two samplers) on a
    4-machine cluster."""
    wl = _jobs()[0][1]
    cluster = ref_core.heterogeneous_cluster(4, seed=3)
    return wl, cluster, ref_core.ifs_placement(wl, cluster, seed=0)


@pytest.mark.parametrize("shaping", (None, "deadline"))
def test_replanner_with_cache_matches_reference(traces, fanin, shaping):
    """A drift re-plan, a leave and a join with a cache tier (a warm hit
    model and per-machine budgets): the same records, incumbents, warm
    model state and budget vectors after each."""
    want_t, got_t = traces
    wl, cluster, p0 = fanin
    cfg = ref_dyn.ReplanConfig(budget=12, sim_iters=4, shaping=shaping, backend="numpy")
    budgets = ref.CacheConfig(policy="lru", cache_gb=[2.0, 40.0, 1.0, 3.0])
    want = ref_dyn.Replanner(wl, cluster, p0.copy(), config=cfg,
                             hit_model=ref.build_hit_model(want_t, capacity_nodes=400),
                             cache_config=budgets)
    got = port_dyn.Replanner(from_reference(wl), from_reference(cluster),
                             from_reference(p0), config=from_reference(cfg, device="cpu"),
                             hit_model=port.build_hit_model(got_t, capacity_nodes=400),
                             cache_config=from_reference(budgets))
    scale = np.array([0.3, 1.0, 1.0, 0.5])
    bw_in, bw_out = cluster.bw_in * scale, cluster.bw_out * scale
    _same_record(want.observe(bw_in, bw_out, served_iters=3),
                 got.observe(bw_in, bw_out, served_iters=3))
    assert got.hit_model.warm_iters == want.hit_model.warm_iters == 3
    assert np.array_equal(want.placement.y, got.placement.y)
    _same_record(want.on_leave(1), got.on_leave(1))
    assert np.array_equal(want.placement.y, got.placement.y)
    assert np.array_equal(got.cache_config.cache_gb, [2.0, 1.0, 3.0])
    joiner = ref_core.Machine("m-join", {"mem": 48.0, "cpu": 16.0, "gpu": 2.0}, 6.25, 6.25)
    _same_record(want.on_join(joiner, cache_gb=4.0), got.on_join(
        from_reference(ref_core.ClusterSpec(machines=[joiner])).machines[0], cache_gb=4.0))
    assert np.array_equal(want.placement.y, got.placement.y)
    assert np.array_equal(got.cache_config.cache_gb, want.cache_config.cache_gb)
    assert np.array_equal(got.cache_config.cache_gb, [2.0, 1.0, 3.0, 4.0])


@pytest.mark.parametrize("strategy", ("static", "replan", "oracle"))
def test_run_scenario_with_cache_matches_reference(traces, fanin, strategy):
    """Two intervals under a drift trace with a warm cache tier: each
    interval's cache-adjusted makespan, the placements and the total."""
    want_t, got_t = traces
    wl, cluster, _ = fanin
    trace = ref_dyn.drift_trace(cluster, horizon_s=8.0, n_segments=4, seed=1,
                                bw_scale_range=(0.25, 1.0))
    cfg = ref_dyn.ReplanConfig(budget=12, sim_iters=4, drift_threshold=0.2,
                               shaping="deadline", backend="numpy")
    budgets = ref.CacheConfig(policy="lru", cache_gb=2.0)
    kw = dict(strategy=strategy, n_intervals=2, iters_per_interval=2, seed=0,
              oracle_budget=12, oracle_chains=2)
    want = ref_dyn.run_scenario(wl, cluster, trace, replan_config=cfg,
                                hit_model=ref.build_hit_model(want_t, capacity_nodes=400),
                                cache_config=budgets, **kw)
    got = port_dyn.run_scenario(from_reference(wl), from_reference(cluster),
                                from_reference(trace),
                                replan_config=from_reference(cfg, device="cpu"),
                                hit_model=port.build_hit_model(got_t, capacity_nodes=400),
                                cache_config=from_reference(budgets), **kw)
    assert len(got.intervals) == len(want.intervals) == 2
    for a, b in zip(want.intervals, got.intervals):
        for k in ("start_s", "makespan_s", "migration_s", "overlap_s", "drift"):
            assert _close(getattr(a, k), getattr(b, k)), k
        assert a.replanned == b.replanned
    for a, b in zip(want.placements, got.placements):
        assert np.array_equal(a.y, b.y)
    assert _close(got.total_s, want.total_s)
    if strategy == "static":
        # the cache removed traffic: the same placement runs slower uncached
        uncached = port_dyn.run_scenario(
            from_reference(wl), from_reference(cluster), from_reference(trace),
            replan_config=from_reference(cfg, device="cpu"), **kw)
        assert got.total_s < uncached.total_s
