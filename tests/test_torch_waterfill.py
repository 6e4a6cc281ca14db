"""The waterfill rate pass: plain version, Pallas kernel, CUDA kernel.

``repro_torch.kernels.waterfill`` holds the CUDA port of the Pallas kernel
``repro.kernels.waterfill.waterfill_fill`` and its plain version.
The function has no multiply-adds (one compare and two subtractions per
grant), so the bar is EXACT equality:

  * the plain version against the Pallas kernel (interpret mode on the
    CPU), on seeded inputs with deliberate key ties in the order;
  * whole fifo/mrtf schedules of the torch engine (plain version on the
    CPU) against ``simulate_batch_jax``'s XLA ``fori_loop`` path;
  * the kernel's host plan (tiles per instance, warps a block, where
    the grants go) on the CPU;
  * on a card (``cuda``-marked, skipped without one), the CUDA kernel
    against the plain version at the tile edges of EG, at M on both
    sides of 32 and of the shared grant row, at B 1, 3 and 1024, and on
    all-ineligible rows, NaN and zero capacities and tied keys; and the
    chain probe's bound against the kernel's time.  Run them there with
    ``python -m pytest -m cuda tests/test_torch_waterfill.py``.  JAX is
    imported only by the tests that compare with it, so these also run
    where JAX is absent.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import build_gnn_workload, heterogeneous_cluster, ifs_placement
from repro_torch.convert import from_reference
from repro_torch.core import simulate_batch_torch
from repro_torch.kernels.waterfill import (
    MAX_WARPS, TILE, chain_probe, launch_plan, tile_count, warp_bytes, waterfill_fill,
    waterfill_fill_plain)


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


@pytest.mark.parametrize("eg,tiles", [(1, 1), (511, 1), (512, 1), (513, 2), (1400, 3)])
def test_tile_count(eg, tiles):
    assert TILE == 512
    assert tile_count(eg) == tiles


def test_launch_plan_fits_a_block():
    # the papers job: 4 instances a block, grants in shared rows (62 KB)
    assert launch_plan(1400, 16) == (MAX_WARPS, True)
    assert 4 * warp_bytes(1400, 16, True) == 4 * (512 * 8 + 16 * 16 + 8 * 1400)
    assert warp_bytes(1, 1, True) % 16 == 0
    # the first kernel's largest M (2 M fp64 for each of 32 instances in
    # 227 KB) still runs
    assert launch_plan(72, 453) == (MAX_WARPS, True)
    # a row too long for shared memory: the grants go to device memory
    warps, row = launch_plan(100_000, 16)
    assert not row and warps == MAX_WARPS
    # one instance a block when M alone fills the shared memory
    assert launch_plan(8, 12_000)[0] == 1
    with pytest.raises(ValueError, match="shared memory"):
        launch_plan(8, 20_000)
    with pytest.raises(ValueError, match="16 bits"):
        launch_plan(8, 40_000)


def test_chain_probe_needs_a_card():
    with pytest.raises(ValueError, match="mode"):
        chain_probe(1400, 16, mode="registers")
    with pytest.raises(ValueError, match="CUDA"):
        chain_probe(1400, 16, device="cpu")


# ----------------------------------------------------------------- the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _check_kernel(args):
    before = waterfill_fill.launches
    got = waterfill_fill(*args)
    torch.cuda.synchronize()
    assert waterfill_fill.launches == before + 1
    want = waterfill_fill_plain(*args)
    assert torch.equal(got, want)
    return want


# (B, EG, M): the tile edges of EG, M on both sides of a warp's 32 lanes
# and up to 200 machines, B 1, 3 and 1024 (the papers job's shape)
KERNEL_SHAPES = (
    [(3, eg, 16) for eg in (1, 511, 512, 513, 1400)]
    + [(3, 600, m) for m in (1, 4, 16, 32, 33, 200)]
    + [(b, 1400, 16) for b in (1, 3, 1024)]
)


@pytest.mark.cuda
@pytest.mark.parametrize("B,EG,M", KERNEL_SHAPES)
def test_cuda_kernel_matches_plain_exactly(cuda, B, EG, M):
    """On a card: the CUDA kernel equals its plain version bit for bit,
    ties included, and counts its launch."""
    args = [torch.from_numpy(a).to(cuda) for a in _inputs(3 + EG + M, B, EG, M)]
    want = _check_kernel(args)
    if EG > 1 and M > 1:  # (with M = 1 the one egress NIC is below EPS)
        assert (want > 0).any()


@pytest.mark.cuda
def test_cuda_kernel_grants_go_to_device_memory(cuda):
    """EG too long for the shared grant row (the kernel writes the grants
    straight to the output row)."""
    assert not launch_plan(40_000, 8)[1]
    _check_kernel([torch.from_numpy(a).to(cuda) for a in _inputs(11, 2, 40_000, 8)])


@pytest.mark.cuda
def test_cuda_kernel_edge_inputs(cuda):
    """All-ineligible rows, NaN and zero capacities, every key tied."""
    B, EG, M = 6, 700, 8
    order, src, dst, elig, cap_in, cap_out = _inputs(12, B, EG, M)
    elig[0] = False  # a row with no eligible flow
    cap_in[1, :] = 0.0  # a row with no ingress capacity
    cap_in[2, ::2] = np.nan  # NaN remainders grant nothing
    cap_out[3, 1] = np.nan
    order[4] = np.arange(EG, dtype=np.int32)  # every key tied: column order
    cap_in[5] = np.inf  # an unbounded NIC: the grant is the egress side
    args = [torch.from_numpy(a).to(cuda) for a in (order, src, dst, elig, cap_in, cap_out)]
    want = _check_kernel(args)
    assert (want[0] == 0).all() and (want[1] == 0).all()
    assert (want[4] > 0).any()


@pytest.mark.cuda
def test_chain_probe_is_below_the_kernel(cuda):
    """The probe's chain bound (the longest instance's eligible steps,
    one dependent chain on chip) is positive and below the kernel's time
    at the papers shape."""
    args = [torch.from_numpy(a).to(cuda) for a in _inputs(13, 1024, 1400, 16)]
    waterfill_fill(*args)
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(20):
        waterfill_fill(*args)
    t1.record()
    torch.cuda.synchronize()
    kernel_ms = t0.elapsed_time(t1) / 20
    bound_ms, cycles = chain_probe(int(args[3].sum(1).max()), 16)
    assert 0 < bound_ms < kernel_ms
    assert cycles > 0
    for mode in ("shared", "shuffle"):
        assert chain_probe(1400, 16, mode=mode)[0] > 0
