"""The waterfill rate pass: plain version, Pallas kernel, CUDA kernel.

``repro_torch.kernels.waterfill`` holds the CUDA port of the Pallas kernel
``repro.kernels.waterfill.waterfill_fill`` and its plain version.
The function has no multiply-adds (one compare and two subtractions per
grant), so the bar is EXACT equality:

  * the plain version against the Pallas kernel (interpret mode on the
    CPU), on seeded inputs with deliberate key ties in the order;
  * whole fifo/mrtf schedules of the torch engine (plain version on the
    CPU) against ``simulate_batch_jax``'s XLA ``fori_loop`` path;
  * on a card (``cuda``-marked, skipped without one), the CUDA kernel
    against the plain version.  JAX is imported only by the tests that
    compare with it, so this one also runs where JAX is absent.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import build_gnn_workload, heterogeneous_cluster, ifs_placement
from repro_torch.convert import from_reference
from repro_torch.core import simulate_batch_torch
from repro_torch.kernels.waterfill import waterfill_fill, waterfill_fill_plain


def _inputs(seed, B, EG, M):
    """Random waterfill inputs: integer-valued keys in a small range (so
    many flows tie) sorted stably, random eligibility, and capacities
    that include exhausted NICs (grants below EPS)."""
    rng = np.random.default_rng(seed)
    key = rng.integers(0, 4, size=(B, EG)).astype(np.float64)
    order = np.argsort(key, axis=1, kind="stable").astype(np.int32)
    src = rng.integers(0, M, size=(B, EG)).astype(np.int32)
    dst = rng.integers(0, M, size=(B, EG)).astype(np.int32)
    elig = rng.random((B, EG)) < 0.7
    cap_in = rng.uniform(0.0, 3.0, size=(B, M))
    cap_out = rng.uniform(0.0, 3.0, size=(B, M))
    cap_in[rng.random((B, M)) < 0.2] = 0.0
    cap_out[:, 0] = 1e-10  # a NIC whose whole capacity is below EPS
    return order, src, dst, elig, cap_in, cap_out


@pytest.mark.parametrize("seed,B,EG,M", [(0, 5, 37, 4), (1, 8, 64, 3), (2, 3, 120, 16)])
def test_plain_matches_pallas_exactly(seed, B, EG, M):
    jax = pytest.importorskip("jax")
    import repro.core.engine_jax  # noqa: F401 (enables float64 in JAX)
    from repro.kernels.waterfill import waterfill_fill as pallas_waterfill_fill

    args = _inputs(seed, B, EG, M)
    want = np.asarray(pallas_waterfill_fill(*(jax.numpy.asarray(a) for a in args)))
    assert want.dtype == np.float64
    got = waterfill_fill_plain(*(torch.from_numpy(a) for a in args)).numpy()
    assert got.dtype == np.float64
    assert np.array_equal(got, want)
    assert (got > 0).any() and (got == 0).any()
    # the CPU wrapper takes the plain version and launches nothing
    before = waterfill_fill.launches
    via_wrapper = waterfill_fill(*(torch.from_numpy(a) for a in args)).numpy()
    assert np.array_equal(via_wrapper, want)
    assert waterfill_fill.launches == before


def test_wrapper_validates_inputs():
    order, src, dst, elig, cap_in, cap_out = (
        torch.from_numpy(a) for a in _inputs(0, 2, 8, 3)
    )
    with pytest.raises(TypeError, match="order"):
        waterfill_fill(order.long(), src, dst, elig, cap_in, cap_out)
    with pytest.raises(ValueError, match="cap_in"):
        waterfill_fill(order, src, dst, elig, cap_in[:, :2], cap_out)
    with pytest.raises(ValueError, match="contiguous"):
        waterfill_fill(order, src, dst, elig, cap_in.t().contiguous().t(), cap_out)


@pytest.mark.parametrize("policy", ("fifo", "mrtf"))
def test_engine_waterfill_matches_xla_path_exactly(policy):
    """fifo arms many flows at the same instant (tied release keys); the
    torch engine's schedules equal the JAX engine's XLA fori_loop path
    bit for bit."""
    pytest.importorskip("jax")
    from repro.core.engine_jax import simulate_batch_jax

    wl = build_gnn_workload(
        n_stores=3, n_workers=2, samplers_per_worker=2, n_ps=1, n_iters=4,
        store_to_sampler_gb=1.0, sampler_to_worker_gb=0.5, grad_gb=0.2,
        store_exec_s=0.3, sampler_exec_s=0.4, worker_exec_s=0.8,
        ps_exec_s=0.2, pmr=1.3,
    )
    cluster = heterogeneous_cluster(3, seed=0)
    placements = [ifs_placement(wl, cluster, seed=s) for s in range(3)]
    reals = [wl.realize(seed=s) for s in range(3)]
    ref = simulate_batch_jax(wl, cluster, placements, reals, policy=policy,
                             record=True)
    got = simulate_batch_torch(
        from_reference(wl), from_reference(cluster),
        [from_reference(p) for p in placements],
        [from_reference(r) for r in reals],
        policy=policy, record=True, device="cpu",
    )
    for b in range(3):
        assert got[b].makespan == ref[b].makespan
        assert np.array_equal(
            got[b].task_start_matrix(wl.J, 4),
            ref[b].task_start_matrix(wl.J, 4), equal_nan=True,
        )


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_exactly():
    """On a card: the CUDA kernel equals its plain version at the engine's
    papers-job shapes (B=1024, EG=1400, M=16), ties included, and counts
    its launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    args = [torch.from_numpy(a).cuda() for a in _inputs(3, 1024, 1400, 16)]
    before = waterfill_fill.launches
    got = waterfill_fill(*args)
    torch.cuda.synchronize()
    assert waterfill_fill.launches == before + 1
    assert torch.equal(got, waterfill_fill_plain(*args))
