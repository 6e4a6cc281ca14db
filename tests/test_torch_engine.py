"""Torch engine on the CPU: parity with the numpy and JAX engines.

``repro_torch.core.engine_torch.simulate_batch_torch`` is the port of the
JAX package's jitted engine.  Its contract is the JAX engine's: agreement
with the numpy reference on makespans and task-start matrices at
``PARITY_RTOL`` / ``PARITY_ATOL`` (float64; sums run in another order).
Inputs are built with the reference's builders and carried across with
``repro_torch.convert.from_reference``; ``n_events`` is not compared
(lock-step iterations by design).

Covered: the five policies at width 3 with ``record=True`` against both
reference engines (the flow log against numpy's), the zero-volume /
zero-exec cascade that forces the multi-round settle fixpoint, and the 15
static cells of the golden suite.  The other regimes are in
``test_torch_engine_regimes.py``.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import (
    build_gnn_workload,
    heterogeneous_cluster,
    ifs_placement,
    simulate_batch,
)
from repro.core.engine_jax import simulate_batch_jax
from repro_torch.convert import from_reference
from repro_torch.core import PARITY_ATOL, PARITY_RTOL, simulate_batch_torch, simulate_torch

from test_golden_schedules import GOLDEN_PATH, JOBS, _cases

POLICIES = ("oes", "oes_strict", "fifo", "mrtf", "omcoflow")


def _assert_parity(wl, ref, got, n_iters):
    """Makespan + full task-start schedule agreement at the pinned tol."""
    assert np.isclose(ref.makespan, got.makespan,
                      rtol=PARITY_RTOL, atol=PARITY_ATOL)
    sm_r = ref.task_start_matrix(wl.J, n_iters)
    sm_g = got.task_start_matrix(wl.J, n_iters)
    assert np.allclose(sm_r, sm_g, rtol=PARITY_RTOL, atol=PARITY_ATOL,
                       equal_nan=True)


def _port(wl, cluster, placements, reals):
    return (
        from_reference(wl),
        from_reference(cluster),
        [from_reference(p) for p in placements],
        [from_reference(r) for r in reals],
    )


@pytest.fixture(scope="module")
def matrix_case():
    wl = build_gnn_workload(
        n_stores=2, n_workers=2, samplers_per_worker=2, n_ps=1, n_iters=4,
        store_to_sampler_gb=1.0, sampler_to_worker_gb=0.5, grad_gb=0.2,
        store_exec_s=0.3, sampler_exec_s=0.4, worker_exec_s=0.8,
        ps_exec_s=0.2, pmr=1.3,
    )
    cluster = heterogeneous_cluster(3, seed=0)
    placements = [ifs_placement(wl, cluster, seed=s) for s in range(3)]
    reals = [wl.realize(seed=s) for s in range(3)]
    return wl, cluster, placements, reals


@pytest.mark.parametrize("policy", POLICIES)
def test_parity_with_numpy_and_jax(matrix_case, policy):
    """5 policies at width 3, recorded, against both reference engines."""
    wl, cluster, placements, reals = matrix_case
    ref = simulate_batch(wl, cluster, placements, reals, policy=policy,
                         record=True, backend="numpy")
    ref_jax = simulate_batch_jax(wl, cluster, placements, reals,
                                 policy=policy, record=True)
    got = simulate_batch_torch(*_port(wl, cluster, placements, reals),
                               policy=policy, record=True, device="cpu")
    assert len(got) == 3
    for b in range(3):
        _assert_parity(wl, ref[b], got[b], reals[0].n_iters)
        _assert_parity(wl, ref_jax[b], got[b], reals[0].n_iters)
        want = {(e, n): (s, t) for e, n, s, t in ref[b].flow_log}
        have = {(e, n): (s, t) for e, n, s, t in got[b].flow_log}
        assert set(have) == set(want)
        for k, v in want.items():
            assert np.allclose(have[k], v, rtol=PARITY_RTOL, atol=PARITY_ATOL)
        assert got[b].policy == policy


@pytest.mark.parametrize("policy", POLICIES)
def test_unrecorded_run_matches_recorded(matrix_case, policy):
    """record=False (the planner's path) gives the same makespans and
    leaves task_events empty."""
    wl, cluster, placements, reals = matrix_case
    args = _port(wl, cluster, placements, reals)
    rec = simulate_batch_torch(*args, policy=policy, record=True, device="cpu")
    plain = simulate_batch_torch(*args, policy=policy, device="cpu")
    assert [r.makespan for r in rec] == [r.makespan for r in plain]
    assert all(r.task_events == [] for r in plain)


@pytest.mark.parametrize("policy", POLICIES)
def test_cascade_settle_parity(policy):
    """Zero-volume edges + zero-exec tasks: instant deliveries and
    zero-duration task starts cascade inside one event instant, forcing
    the multi-round settle fixpoint."""
    for seed in (0, 1):
        wl = build_gnn_workload(
            n_stores=2, n_workers=2, samplers_per_worker=1, n_ps=1,
            n_iters=4, store_to_sampler_gb=0.6, sampler_to_worker_gb=0.0,
            grad_gb=0.3, store_exec_s=0.3, sampler_exec_s=0.0,
            worker_exec_s=0.5, ps_exec_s=0.2, pmr=1.2,
        )
        cluster = heterogeneous_cluster(3, seed=seed)
        placements = [ifs_placement(wl, cluster, seed=s) for s in range(3)]
        reals = [wl.realize(seed=s) for s in range(3)]
        ref = simulate_batch(wl, cluster, placements, reals, policy=policy,
                             record=True, backend="numpy")
        ref_jax = simulate_batch_jax(wl, cluster, placements, reals,
                                     policy=policy, record=True)
        got = simulate_batch_torch(*_port(wl, cluster, placements, reals),
                                   policy=policy, record=True, device="cpu")
        for b in range(3):
            _assert_parity(wl, ref[b], got[b], reals[0].n_iters)
            _assert_parity(wl, ref_jax[b], got[b], reals[0].n_iters)


@pytest.fixture(scope="module")
def golden():
    assert GOLDEN_PATH.exists()
    return json.loads(GOLDEN_PATH.read_text())


@pytest.mark.parametrize("name", JOBS)
def test_golden_static_torch(golden, name):
    """The static regime of every golden job, for all five policies, on
    the torch engine at the pinned tolerance."""
    for (nm, rg, wl, cluster, placement, realization, trace, flows,
         shaping) in _cases():
        if (nm, rg) != (name, "static"):
            continue
        assert trace is None and flows is None and shaping is None
        twl = from_reference(wl)
        for policy in POLICIES:
            pinned = golden[name]["static"][policy]
            res = simulate_torch(
                twl, from_reference(cluster), from_reference(placement),
                from_reference(realization), policy=policy, record=True,
                device="cpu",
            )
            assert np.isclose(res.makespan, pinned["makespan"],
                              rtol=PARITY_RTOL, atol=PARITY_ATOL)
            starts = res.task_start_matrix(wl.J, realization.n_iters)
            assert np.allclose(starts, np.array(pinned["task_start"]),
                               rtol=PARITY_RTOL, atol=PARITY_ATOL)


def test_rejects_unported_policy(matrix_case):
    wl, cluster, placements, reals = matrix_case
    with pytest.raises(ValueError, match="built-in rate policies"):
        simulate_batch_torch(*_port(wl, cluster, placements, reals),
                             policy="oes+strict", device="cpu")


def test_float64_and_parity_constants():
    """The port pins the JAX engine's tolerance and EPS, and runs float64."""
    from repro.core import engine as ref_engine
    from repro.core import engine_jax
    from repro_torch.core import EPS, engine_torch
    from repro_torch.kernels import waterfill

    assert (PARITY_RTOL, PARITY_ATOL) == (
        engine_jax.PARITY_RTOL, engine_jax.PARITY_ATOL
    )
    assert EPS == waterfill.EPS == ref_engine.EPS
    assert engine_torch.F64 is torch.float64
