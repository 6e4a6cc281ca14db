"""The port's planner against the reference's, on the CPU.

The port keeps its own copies of the cluster, workload and profile
builders and of the ETP search; these tests hold them to the JAX
package's numpy reference:

  * the builders produce the same arrays, and ``realize(seed)`` the same
    draws (the same numpy ``default_rng`` streams);
  * ``from_reference`` carries every planning object across unchanged;
  * ``etp_multichain(device="cpu")`` finds the same best placement and
    best makespan as ``etp_multichain(backend="numpy")`` at equal seeds;
  * ``plan()`` picks the same placement as the reference's, and its
    Theorem-1 certificate, built from the torch engine's recorded
    schedule (task events and flow log), equals the reference's.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core as ref
from repro.core.profiles import OGBN_PAPERS100M as REF_PAPERS
from repro.core.profiles import OGBN_PRODUCTS as REF_PRODUCTS
import repro_torch.core as port
from repro_torch.convert import from_reference
from repro_torch.core import PARITY_ATOL, PARITY_RTOL


def _jobs(lib, products, papers):
    """(name, workload, cluster) built by one package's own builders."""
    return [
        (
            "small",
            lib.build_gnn_workload(
                n_stores=2, n_workers=2, samplers_per_worker=2, n_ps=1,
                n_iters=4, store_to_sampler_gb=1.0, sampler_to_worker_gb=0.5,
                grad_gb=0.2, store_exec_s=0.3, sampler_exec_s=0.4,
                worker_exec_s=0.8, ps_exec_s=0.2, pmr=1.3,
            ),
            lib.heterogeneous_cluster(3, seed=0),
        ),
        (
            "products",
            lib.build_workload_from_profile(
                products, n_stores=4, n_workers=6, samplers_per_worker=2,
                n_ps=1, n_iters=40,
            ),
            lib.testbed_cluster(),
        ),
        (
            "papers",
            lib.build_workload_from_profile(
                papers, n_stores=16, n_workers=20, samplers_per_worker=4,
                n_ps=1, n_iters=10,
            ),
            lib.heterogeneous_cluster(16, seed=1),
        ),
    ]


def _same_workload(a, b):
    assert (a.J, a.E, a.n_iters) == (b.J, b.E, b.n_iters)
    for name in ("edge_src", "edge_dst", "edge_lag", "kinds"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), name
    assert a.task_names() == b.task_names()
    assert a.sampler_of_worker == b.sampler_of_worker
    assert a.store_tasks == b.store_tasks
    ta, tb = a.traffic, b.traffic
    assert np.array_equal(ta.mean_volume, tb.mean_volume)
    assert np.array_equal(ta.mean_exec, tb.mean_exec)
    assert np.array_equal(ta.fluctuating, tb.fluctuating)
    assert (ta.pmr, ta.exec_jitter) == (tb.pmr, tb.exec_jitter)


def _same_cluster(a, b):
    assert a.M == b.M and a.resource_types == b.resource_types
    for name in ("cap", "bw_in", "bw_out"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.parametrize("idx", [0, 1, 2])
def test_builders_and_draws_match_reference(idx):
    name, rwl, rcl = _jobs(ref, REF_PRODUCTS, REF_PAPERS)[idx]
    _, pwl, pcl = _jobs(port, port.OGBN_PRODUCTS, port.OGBN_PAPERS100M)[idx]
    _same_workload(rwl, pwl)
    _same_cluster(rcl, pcl)
    _same_workload(rwl, from_reference(rwl))
    _same_cluster(rcl, from_reference(rcl))
    for seed in (0, 7):
        r, p = rwl.realize(seed=seed), pwl.realize(seed=seed)
        assert np.array_equal(r.volumes, p.volumes)
        assert np.array_equal(r.exec_times, p.exec_times)
        c = from_reference(r)
        assert np.array_equal(c.volumes, r.volumes)
        assert np.array_equal(c.exec_times, r.exec_times)
    assert np.array_equal(
        ref.distdgl_placement(rwl, rcl).y, port.distdgl_placement(pwl, pcl).y
    )
    if name != "papers":  # IFS's DP over 16 machines takes seconds
        p = ref.ifs_placement(rwl, rcl, seed=3)
        assert np.array_equal(p.y, port.ifs_placement(pwl, pcl, seed=3).y)
        assert np.array_equal(from_reference(p).y, p.y)


def test_draws_and_seed_derivation_match_reference():
    from repro.core.multijob import SEED_NS_CHAIN, derive_seed
    from repro_torch.core.multijob import SEED_NS_CHAIN as PORT_NS
    from repro_torch.core.multijob import derive_seed as port_derive

    assert PORT_NS == SEED_NS_CHAIN
    for base, idx in ((0, 0), (3, 5), (2**40, 17)):
        assert port_derive(base, PORT_NS, idx) == derive_seed(
            base, SEED_NS_CHAIN, idx
        )
    _, rwl, _ = _jobs(ref, REF_PRODUCTS, REF_PAPERS)[0]
    pwl = from_reference(rwl)
    a = ref.monte_carlo_draws(rwl, seed=5, n_iters=3, n_draws=3)
    b = port.monte_carlo_draws(pwl, seed=5, n_iters=3, n_draws=3)
    for x, y in zip(a, b):
        assert np.array_equal(x.volumes, y.volumes)
        assert np.array_equal(x.exec_times, y.exec_times)


@pytest.fixture(scope="module")
def search_case():
    wl = ref.build_gnn_workload(
        n_stores=3, n_workers=3, samplers_per_worker=1, n_ps=1, n_iters=4,
        store_to_sampler_gb=0.8, sampler_to_worker_gb=0.4, grad_gb=0.25,
        store_exec_s=0.3, sampler_exec_s=0.4, worker_exec_s=0.8,
        ps_exec_s=0.2, pmr=1.3,
    )
    return wl, ref.heterogeneous_cluster(3, seed=2)


@pytest.mark.parametrize("policy", ("oes", "fifo"))
def test_etp_multichain_matches_reference(search_case, policy):
    wl, cluster = search_case
    kw = dict(n_chains=4, budget=48, seed=1, sim_iters=3, policy=policy)
    want = ref.etp_multichain(wl, cluster, backend="numpy", **kw)
    got = port.etp_multichain(
        from_reference(wl), from_reference(cluster), device="cpu", **kw
    )
    assert np.array_equal(got.placement.y, want.placement.y)
    assert np.isclose(got.best_makespan, want.best_makespan,
                      rtol=PARITY_RTOL, atol=PARITY_ATOL)
    assert got.evaluations == want.evaluations
    assert (got.proposals, got.accepted) == (want.proposals, want.accepted)


def test_plan_matches_reference(search_case):
    wl, cluster = search_case
    r = wl.realize(seed=0)
    kw = dict(budget=32, sim_iters=3, seed=0)
    want = ref.plan(wl, cluster, realization=r, backend="numpy", **kw)
    got = port.plan(
        from_reference(wl), from_reference(cluster),
        realization=from_reference(r), device="cpu", **kw,
    )
    assert port.DEFAULT_N_CHAINS["cpu"] == 8
    assert np.array_equal(got.placement.y, want.placement.y)
    assert np.isclose(got.schedule.makespan, want.schedule.makespan,
                      rtol=PARITY_RTOL, atol=PARITY_ATOL)
    assert np.allclose(
        got.schedule.task_start_matrix(wl.J, r.n_iters),
        want.schedule.task_start_matrix(wl.J, r.n_iters),
        rtol=PARITY_RTOL, atol=PARITY_ATOL,
    )
    assert got.delta == want.delta
    assert got.traffic == want.traffic
    _same_certificate(got.certificate, want.certificate)


def _same_certificate(got, want):
    """The Theorem-1 certificate built from the torch schedule equals the
    one built from numpy's."""
    assert (got.delta, got.chain_len, got.holds) == (want.delta, want.chain_len, want.holds)
    for k in ("lower_bound", "makespan", "p_sum", "flow_term"):
        assert np.isclose(getattr(got, k), getattr(want, k),
                          rtol=PARITY_RTOL, atol=PARITY_ATOL), k


def test_plan_baseline_matches_reference(search_case):
    wl, cluster = search_case
    r = wl.realize(seed=0)
    want = ref.plan_baseline(wl, cluster, baseline="distdgl", realization=r)
    got = port.plan_baseline(
        from_reference(wl), from_reference(cluster), baseline="distdgl",
        realization=from_reference(r), device="cpu",
    )
    assert np.array_equal(got.placement.y, want.placement.y)
    assert got.schedule.policy == "fifo"
    assert np.isclose(got.schedule.makespan, want.schedule.makespan,
                      rtol=PARITY_RTOL, atol=PARITY_ATOL)


@pytest.mark.parametrize("baseline", (None, "distdgl", "mrtf"))
def test_certificate_matches_reference_on_quickstart_job(baseline):
    """The quickstart job (examples/quickstart.py: ogbn-products, 4
    stores, 6 workers x 2 samplers, 1 PS, 40 iterations, the testbed
    cluster): ``plan()`` at a small budget and ``plan_baseline``; each
    certificate equals the reference's and holds."""
    wl = ref.build_workload_from_profile(
        REF_PRODUCTS, n_stores=4, n_workers=6, samplers_per_worker=2, n_ps=1,
        n_iters=40,
    )
    cluster = ref.testbed_cluster()
    r = wl.realize(seed=0)
    args = (from_reference(wl), from_reference(cluster))
    if baseline is None:
        kw = dict(budget=16, sim_iters=4, seed=0, n_chains=4)
        want = ref.plan(wl, cluster, realization=r, backend="numpy", **kw)
        got = port.plan(*args, realization=from_reference(r), device="cpu", **kw)
    else:
        want = ref.plan_baseline(wl, cluster, baseline=baseline, realization=r)
        got = port.plan_baseline(*args, baseline=baseline,
                                 realization=from_reference(r), device="cpu")
    assert np.array_equal(got.placement.y, want.placement.y)
    _same_certificate(got.certificate, want.certificate)
    assert got.certificate.holds
