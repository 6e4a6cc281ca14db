"""The port's multi-job planning against the reference's, on the CPU.

  * ``merge_workloads``, ``realize_merged``, ``merge_migrations``,
    ``merged_edge_classes`` and ``IncrementalMerge`` give the reference's
    tasks, edges, offsets, tokens and arrays exactly (the same seed
    namespaces, the same numpy streams);
  * ``merged_batch_cost``, ``joint_search`` (the same placement and best
    cost), ``per_job_makespans`` and ``per_job_iteration_ends`` match at
    ``PARITY_RTOL`` / ``PARITY_ATOL``;
  * the search hooks (``extra_violation``, ``batch_cost_fn``) give the
    reference's searches;
  * per-job accounting of an unrecorded result raises ``ValueError``.

The jobs are ``tests/test_multijob.py``'s pair: ogbn-products 4/3x2/1 for
12 iterations and reddit 4/2x2/1 for 8, on a 4-machine cluster.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core as ref_core
from repro.core import multijob as ref_mj
import repro_torch.core as port_core
from repro_torch.convert import from_reference
from repro_torch.core import PARITY_ATOL, PARITY_RTOL
from repro_torch.core import multijob as port_mj

from test_multijob import two_jobs


def _close(a, b):
    return bool(np.allclose(a, b, rtol=PARITY_RTOL, atol=PARITY_ATOL))


def _same_workload(a, b):
    assert [(t.name, t.kind, t.demand) for t in a.tasks] == [
        (t.name, t.kind, t.demand) for t in b.tasks
    ]
    assert [(e.src, e.dst, e.lag, e.kind) for e in a.edges] == [
        (e.src, e.dst, e.lag, e.kind) for e in b.edges
    ]
    for k in ("mean_volume", "mean_exec", "fluctuating"):
        assert np.array_equal(getattr(a.traffic, k), getattr(b.traffic, k)), k
    assert (a.traffic.pmr, a.traffic.exec_jitter) == (b.traffic.pmr, b.traffic.exec_jitter)
    assert (a.n_iters, a.is_merged, a.store_tasks) == (b.n_iters, b.is_merged, b.store_tasks)
    assert a.sampler_of_worker == b.sampler_of_worker


def _same_merged(a, b):
    _same_workload(a.workload, b.workload)
    assert (a.task_offsets, a.n_iters, a.job_seeds, a.names) == (
        b.task_offsets, b.n_iters, b.job_seeds, b.names
    )
    assert len(a.jobs) == len(b.jobs)
    for x, y in zip(a.jobs, b.jobs):
        _same_workload(x, y)


def _same_real(a, b):
    assert np.array_equal(a.volumes, b.volumes)
    assert np.array_equal(a.exec_times, b.exec_times)


@pytest.fixture(scope="module")
def pair():
    j1, j2 = two_jobs()
    cluster = ref_core.heterogeneous_cluster(4, seed=3, gpu_range=(2, 4))
    return (j1, j2), cluster


def test_seed_namespaces_equal_reference():
    for k in ("SEED_NS_JOB", "SEED_NS_DRAW", "SEED_NS_CHAIN", "EPS_EXEC"):
        assert getattr(port_mj, k) == getattr(ref_mj, k), k
    for base in (0, 5, 2**40 + 3):
        for ns in (port_mj.SEED_NS_JOB, port_mj.SEED_NS_DRAW):
            for i in range(6):
                assert port_mj.derive_seed(base, ns, i) == ref_mj.derive_seed(base, ns, i)


@pytest.mark.parametrize("tokens", (False, True))
def test_merge_and_realize_equal_reference(pair, tokens):
    """The merged workload, its offsets and names, and the merged draws
    (per-job streams keyed by position or by stable tokens, with and
    without a horizon cap) equal the reference's exactly."""
    jobs, _ = pair
    kw = dict(job_seeds=[5, 2], names=["alpha", "beta"]) if tokens else {}
    want = ref_mj.merge_workloads(jobs, **kw)
    got = port_mj.merge_workloads([from_reference(j) for j in jobs], **kw)
    _same_merged(want, got)
    for seed in (0, 7):
        for n_iters in (None, 5):
            _same_real(ref_mj.realize_merged(want, seed=seed, n_iters=n_iters),
                       port_mj.realize_merged(got, seed=seed, n_iters=n_iters))
    with pytest.raises(ValueError, match="realize_merged"):
        got.workload.realize(seed=0)  # repro-lint: disable=RL002
    # a MergedJob carried across is the same merge
    _same_merged(want, from_reference(want))


def test_merge_migrations_and_edge_classes_equal_reference(pair):
    jobs, _ = pair
    want = ref_mj.merge_workloads(jobs)
    got = port_mj.merge_workloads([from_reference(j) for j in jobs])
    flows = [
        [ref_core.MigrationFlow(src=0, dst=2, gb=1.5, task=3)],
        [ref_core.MigrationFlow(src=1, dst=3, gb=3.0, task=4, cls=2, deadline=2.5),
         ref_core.MigrationFlow(src=0, dst=1, gb=0.5)],
    ]
    a = ref_mj.merge_migrations(want, flows)
    b = port_mj.merge_migrations(got, [[from_reference(f) for f in fs] for fs in flows])
    assert [(f.src, f.dst, f.gb, f.task, f.cls, f.deadline) for f in a] == [
        (f.src, f.dst, f.gb, f.task, f.cls, f.deadline) for f in b
    ]
    assert np.array_equal(ref_mj.merged_edge_classes(want, [0, 3]),
                          port_mj.merged_edge_classes(got, [0, 3]))
    with pytest.raises(ValueError, match="flow sets"):
        port_mj.merge_migrations(got, [[]])
    with pytest.raises(ValueError, match="job_classes"):
        port_mj.merged_edge_classes(got, [0])


def test_incremental_merge_equal_reference(pair):
    """The same stream of joins, leaves and residual horizons through
    both packages' ``IncrementalMerge``: the same tokens, merges and
    memoised draws, and the same errors."""
    (j1, j2), _ = pair
    ref_inc, port_inc = ref_mj.IncrementalMerge(), port_mj.IncrementalMerge()
    p1, p2 = from_reference(j1), from_reference(j2)
    assert ref_inc.add_job("alpha", j1) == port_inc.add_job("alpha", p1)
    assert ref_inc.add_job("beta", j2) == port_inc.add_job("beta", p2)
    steps = [({}, 3, None), ({"alpha": 4}, 3, 3)]
    for n_iters, seed, cap in steps:
        want, got = ref_inc.merged(n_iters), port_inc.merged(n_iters)
        _same_merged(want, got)
        _same_real(ref_inc.realize(want, seed=seed, n_iters=cap),
                   port_inc.realize(got, seed=seed, n_iters=cap))
        # the incremental draws are realize_merged's
        _same_real(port_inc.realize(got, seed=seed, n_iters=cap),
                   port_mj.realize_merged(got, seed=seed, n_iters=cap))
    ref_inc.remove_job("alpha")
    port_inc.remove_job("alpha")
    assert ref_inc.add_job("gamma", j1) == port_inc.add_job("gamma", p1)
    assert port_inc.names == ref_inc.names == ["beta", "gamma"]
    assert port_inc.token("gamma") == ref_inc.token("gamma") == 2
    want, got = ref_inc.merged({"beta": 3}), port_inc.merged({"beta": 3})
    _same_merged(want, got)
    _same_real(ref_inc.realize(want, seed=11), port_inc.realize(got, seed=11))
    with pytest.raises(ValueError, match="already in the merge"):
        port_inc.add_job("beta", p2)
    with pytest.raises(ValueError, match="already-merged"):
        port_inc.add_job("delta", got.workload)
    with pytest.raises(ValueError, match="bad residual horizon"):
        port_inc.merged({"beta": 0})
    with pytest.raises(KeyError):
        port_inc.remove_job("alpha")


def _placements(wl, cluster):
    ps = [ref_core.ifs_placement(wl, cluster, seed=s) for s in (0, 1, 2)]
    moved = ps[0].copy()
    moved.y[-4:] = (moved.y[-4:] + 1) % cluster.M
    return ps + [moved]


@pytest.mark.parametrize("policy", ("oes", "fifo"))
def test_merged_batch_cost_matches_reference(pair, policy):
    """The batched merged objective (two merged draws per placement, one
    batch) under OES and under DistDGL's fifo, whose rates are
    waterfill's."""
    jobs, cluster = pair
    mj = ref_mj.merge_workloads(jobs)
    ps = _placements(mj.workload, cluster)
    want = ref_mj.merged_batch_cost(mj, jobs, cluster, n_draws=2, seed=3,
                                    policy=policy, backend="numpy")(ps)
    pmj = from_reference(mj)
    got = port_mj.merged_batch_cost(pmj, None, from_reference(cluster), n_draws=2,
                                    seed=3, policy=policy,
                                    device="cpu")([from_reference(p) for p in ps])
    assert _close(got, want), (got, want)


def test_joint_search_matches_reference(pair):
    """Lock-step multi-chain ETP over the merged job with the batched
    merged cost: the same winner and best cost, the same evaluations."""
    jobs, cluster = pair
    mj, want = ref_mj.joint_search(jobs, cluster, n_chains=2, budget=16, seed=0,
                                   backend="numpy")
    pmj, got = port_mj.joint_search([from_reference(j) for j in jobs],
                                    from_reference(cluster), n_chains=2,
                                    budget=16, seed=0, device="cpu")
    _same_merged(mj, pmj)
    assert np.array_equal(want.placement.y, got.placement.y)
    assert _close(got.best_makespan, want.best_makespan)
    assert (got.evaluations, got.accepted, got.fallback) == (
        want.evaluations, want.accepted, want.fallback
    )


@pytest.mark.parametrize("regime", ("static", "migrations", "classes"))
def test_per_job_accounting_matches_reference(pair, regime):
    """Recorded merged runs (plain; with per-job migration flows lifted
    onto the merged index space; with per-job classes under strict
    shaping): each job's makespan and true-iteration completion times."""
    jobs, cluster = pair
    mj = ref_mj.merge_workloads(jobs)
    pmj = from_reference(mj)
    p = ref_core.ifs_placement(mj.workload, cluster, seed=0)
    r = ref_mj.realize_merged(mj, seed=0)
    kw = {}
    if regime == "migrations":
        flows = [[], [ref_core.MigrationFlow(src=(int(p.y[mj.task_offsets[1] + 4]) + 1) % 4,
                                             dst=int(p.y[mj.task_offsets[1] + 4]),
                                             gb=3.0, task=4)]]
        kw = dict(migrations=ref_mj.merge_migrations(mj, flows))
        pkw = dict(migrations=port_mj.merge_migrations(
            pmj, [[from_reference(f) for f in fs] for fs in flows]))
    elif regime == "classes":
        kw = dict(shaping="strict", edge_classes=ref_mj.merged_edge_classes(mj, [1, 0]))
        pkw = dict(shaping="strict", edge_classes=port_mj.merged_edge_classes(pmj, [1, 0]))
    else:
        pkw = {}
    want = ref_core.simulate(mj.workload, cluster, p, r, record=True, backend="numpy", **kw)
    got = port_core.simulate_torch(pmj.workload, from_reference(cluster),
                                   from_reference(p), from_reference(r), record=True,
                                   device="cpu", **pkw)
    assert _close(port_mj.per_job_makespans(pmj, got), ref_mj.per_job_makespans(mj, want))
    ends_w = ref_mj.per_job_iteration_ends(mj, want)
    ends_g = port_mj.per_job_iteration_ends(pmj, got)
    assert [len(e) for e in ends_g] == [len(e) for e in ends_w] == mj.n_iters
    for a, b in zip(ends_g, ends_w):
        assert _close(a, b)


def test_per_job_accounting_refuses_unrecorded_results(pair):
    jobs, cluster = pair
    pmj = port_mj.merge_workloads([from_reference(j) for j in jobs])
    pc = from_reference(cluster)
    p = port_core.ifs_placement(pmj.workload, pc, seed=0)
    r = port_mj.realize_merged(pmj, seed=0, n_iters=2)
    res = port_core.simulate_torch(pmj.workload, pc, p, r, device="cpu")
    with pytest.raises(ValueError, match="record=True"):
        port_mj.per_job_makespans(pmj, res)
    with pytest.raises(ValueError, match="simulate_torch"):
        port_mj.per_job_iteration_ends(pmj, res)


def test_search_hooks_match_reference(pair):
    """``etp_search(extra_violation=...)`` and
    ``etp_multichain(batch_cost_fn=...)`` on the merged job: the same
    searches as the reference's with the same hooks; a scalar
    ``cost_fn`` beats ``batch_cost_fn``."""
    jobs, cluster = pair
    mj = ref_mj.merge_workloads(jobs)
    pmj, pc = from_reference(mj), from_reference(cluster)

    def extra(p):  # a penalty the demand matrix cannot express
        return 0.02 * float(np.count_nonzero(p.y == 0))

    ref_cost = ref_mj.merged_batch_cost(mj, None, cluster, seed=1, backend="numpy")
    port_cost = port_mj.merged_batch_cost(pmj, None, pc, seed=1, device="cpu")
    want = ref_core.etp_search(mj.workload, cluster, budget=6, seed=0,
                               cost_fn=lambda p: ref_cost([p])[0],
                               extra_violation=extra)
    got = port_core.etp_search(pmj.workload, pc, budget=6, seed=0,
                               cost_fn=lambda p: port_cost([p])[0],
                               extra_violation=extra, device="cpu")
    assert np.array_equal(want.placement.y, got.placement.y)
    assert _close(got.best_makespan, want.best_makespan)
    assert _close(got.cost_trace, want.cost_trace)
    calls = []

    def counted(ps):
        calls.append(len(ps))
        return port_cost(ps)

    want = ref_core.etp_multichain(mj.workload, cluster, n_chains=2, budget=8, seed=0,
                                   batch_cost_fn=ref_cost)
    got = port_core.etp_multichain(pmj.workload, pc, n_chains=2, budget=8, seed=0,
                                   batch_cost_fn=counted, device="cpu")
    assert np.array_equal(want.placement.y, got.placement.y)
    assert _close(got.best_makespan, want.best_makespan)
    assert calls and max(calls) == 2  # one call a lock-step step
    n_calls = len(calls)
    scalar = port_core.etp_multichain(pmj.workload, pc, n_chains=2, budget=4, seed=0,
                                      cost_fn=lambda p: 1.0, batch_cost_fn=counted,
                                      device="cpu")
    assert scalar.best_makespan == 1.0 and len(calls) == n_calls
