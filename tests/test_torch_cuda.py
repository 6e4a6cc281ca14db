"""The port on a CUDA card against the same port on the CPU.

The torch engine (static, and under a trace, flows and deadline
shaping), the arrival service, multi-job search and cache-aware search
(each under fifo, so that waterfill runs), the GraphSAGE aggregation kernels (the forward at
each access width, and the backward) against their plain versions, GraphSAGE's
forward and backward, the gemma2, zamba2, hubert and llava smoke
models (fp32 forward, prefill and decode), and the wgmma probe
(``csrc/wgmma_probe.cu``: one block of m64nNk16 products through the
helpers of ``csrc/sm90.cuh`` against ``torch.matmul``).  Marked ``cuda``:
those tests skip without a card (the engine's fifo and mrtf rates and
the kernels have no CPU mode).  One CPU test: a library's digest covers
the headers its source includes.  On a machine with a card, run the
card's tests (this file, the aggregation's and the waterfill kernel's):

    python -m pytest -m cuda tests/test_torch_cuda.py tests/test_torch_sage.py \
        tests/test_torch_waterfill.py

This file imports torch, numpy and the port only, so it runs where JAX
is absent.
"""
import ctypes
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (
    PARITY_ATOL,
    PARITY_RTOL,
    build_gnn_workload,
    heterogeneous_cluster,
    ifs_placement,
    simulate_batch_torch,
)
from repro_torch.data.graph import sample_blocks, synthetic_graph
from repro_torch.kernels import _build
from repro_torch.kernels.sage_aggregate import (
    forward_plan,
    gather_probe,
    long_plan,
    sage_aggregate,
    sage_aggregate_backward,
    sage_aggregate_backward_plain,
    sage_aggregate_plain,
)
from repro_torch.kernels.waterfill import waterfill_fill
from repro_torch.models import GraphSAGE, SageConfig, batch_to, sage_loss


def test_build_digest_covers_headers(tmp_path):
    """Editing a header beside a source (csrc/*.cuh) changes the digest in
    its library's name, so the source is rebuilt; other files do not."""
    csrc = _build.BUILD_DIR.parent / "src" / "repro_torch" / "kernels" / "csrc"
    for name in ("flash_attention.cu", "sm90.cuh"):
        shutil.copy(csrc / name, tmp_path / name)
    source = tmp_path / "flash_attention.cu"
    before = _build.digest(source)
    assert before == _build.digest(source)
    (tmp_path / "notes.txt").write_text("not a header")
    assert _build.digest(source) == before
    with open(tmp_path / "sm90.cuh", "a") as f:
        f.write("// edited\n")
    assert _build.digest(source) != before


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("policy", ("oes", "oes_strict", "fifo", "mrtf", "omcoflow"))
@pytest.mark.cuda
def test_engine_matches_cpu(cuda, policy):
    wl = build_gnn_workload(
        n_stores=2, n_workers=2, samplers_per_worker=2, n_ps=1, n_iters=4,
        store_to_sampler_gb=1.0, sampler_to_worker_gb=0.5, grad_gb=0.2,
        store_exec_s=0.3, sampler_exec_s=0.4, worker_exec_s=0.8,
        ps_exec_s=0.2, pmr=1.3,
    )
    cluster = heterogeneous_cluster(3, seed=0)
    placements = [ifs_placement(wl, cluster, seed=s) for s in range(3)]
    reals = [wl.realize(seed=s) for s in range(3)]
    before = waterfill_fill.launches
    got = simulate_batch_torch(wl, cluster, placements, reals, policy=policy,
                               record=True, device=cuda)
    if policy in ("fifo", "mrtf"):
        assert waterfill_fill.launches > before
    ref = simulate_batch_torch(wl, cluster, placements, reals, policy=policy,
                               record=True, device="cpu")
    for g, r in zip(got, ref):
        assert np.isclose(g.makespan, r.makespan, rtol=PARITY_RTOL,
                          atol=PARITY_ATOL)
        assert np.allclose(g.task_start_matrix(wl.J, 4),
                           r.task_start_matrix(wl.J, 4),
                           rtol=PARITY_RTOL, atol=PARITY_ATOL, equal_nan=True)


@pytest.mark.cuda
def test_engine_regimes_match_cpu(cuda):
    """fifo under a trace with slowdowns, different migration flows per
    instance (one none) and deadline shaping, recorded, with the
    utilization integrals: the card equals the CPU, flow log included,
    and the shaped passes launch the waterfill kernel."""
    from repro_torch.core import MigrationFlow
    from repro_torch.dynamics import DynamicsEvent, trace_from_events

    wl = build_gnn_workload(
        n_stores=2, n_workers=2, samplers_per_worker=2, n_ps=1, n_iters=4,
        store_to_sampler_gb=1.0, sampler_to_worker_gb=0.5, grad_gb=0.2,
        store_exec_s=0.3, sampler_exec_s=0.4, worker_exec_s=0.8,
        ps_exec_s=0.2, pmr=1.3,
    )
    cluster = heterogeneous_cluster(3, seed=0)
    trace = trace_from_events(cluster, [
        DynamicsEvent(t0=1.5, t1=6.0, machine=0, bw_scale=0.4),
        DynamicsEvent(t0=3.0, machine=None, bw_scale=0.75, slowdown=1.2),
    ])
    placements = [ifs_placement(wl, cluster, seed=s) for s in range(3)]
    reals = [wl.realize(seed=s) for s in range(3)]
    migs = [
        [MigrationFlow(src=1, dst=0, gb=1.2, task=0, deadline=0.5),
         MigrationFlow(src=0, dst=1, gb=0.5)],
        None,
        [MigrationFlow(src=2, dst=1, gb=0.8, task=wl.J - 1, deadline=3.0)],
    ]
    kw = dict(policy="fifo", record=True, trace=trace, migrations=migs,
              shaping="deadline", utilization=True)
    before = waterfill_fill.launches
    got = simulate_batch_torch(wl, cluster, placements, reals, device=cuda, **kw)
    assert waterfill_fill.launches > before
    ref = simulate_batch_torch(wl, cluster, placements, reals, device="cpu", **kw)
    for g, r in zip(got, ref):
        assert np.isclose(g.makespan, r.makespan, rtol=PARITY_RTOL,
                          atol=PARITY_ATOL)
        assert np.allclose(g.task_start_matrix(wl.J, 4),
                           r.task_start_matrix(wl.J, 4),
                           rtol=PARITY_RTOL, atol=PARITY_ATOL, equal_nan=True)
        assert [f[:2] for f in g.flow_log] == [f[:2] for f in r.flow_log]
        assert np.allclose([f[2:] for f in g.flow_log], [f[2:] for f in r.flow_log],
                           rtol=PARITY_RTOL, atol=PARITY_ATOL)
        for key in ("nic_in_gb", "nic_out_gb", "busy_s"):
            assert np.allclose(g.aggregates[key], r.aggregates[key],
                               rtol=PARITY_RTOL, atol=PARITY_ATOL)


def _compute_job(n_iters=4, heavy=1.0):
    return build_gnn_workload(
        n_stores=2, n_workers=1, samplers_per_worker=1, n_ps=1,
        n_iters=n_iters, store_to_sampler_gb=0.2, sampler_to_worker_gb=0.1,
        grad_gb=0.05, store_exec_s=0.1, sampler_exec_s=0.2,
        worker_exec_s=2.0 * heavy, ps_exec_s=0.1, pmr=1.2,
    )


@pytest.mark.cuda
def test_service_matches_cpu(cuda):
    """``run_service`` under fifo with warm re-planning, and an ordering
    baseline, on the card: the same decisions as on the CPU, the times at
    the engine's parity tolerance, and waterfill launched."""
    from repro_torch.dynamics import (
        JobArrival,
        ReplanConfig,
        ServiceConfig,
        run_ordering_baseline,
        run_service,
        solo_makespan,
    )

    cluster = heterogeneous_cluster(4, seed=3, gpu_range=(2, 4))
    stream = []
    for i, (t0, qos) in enumerate([(0.0, 0), (0.5, 1), (1.0, 1)]):
        job = _compute_job()
        solo = solo_makespan(job, cluster, seed=0, index=i, device="cpu")
        stream.append(JobArrival(f"t{i}", t0, job, deadline_s=t0 + 1.6 * solo, qos=qos))
    stream.append(JobArrival("doomed", 0.75, _compute_job(), deadline_s=1.0))

    def service(dev):
        rc = ReplanConfig(budget=4, sim_iters=2, shaping="strict", policy="fifo",
                          device=dev)
        return run_service(stream, cluster, ServiceConfig(policy="fifo",
                                                          replan_config=rc,
                                                          device=dev))

    before = waterfill_fill.launches
    got = service(cuda)
    assert waterfill_fill.launches > before
    want = service("cpu")
    assert [(e.kind, e.job) for e in got.events] == [(e.kind, e.job) for e in want.events]
    assert np.allclose([e.t for e in got.events], [e.t for e in want.events],
                       rtol=PARITY_RTOL, atol=PARITY_ATOL)
    assert [(e.jobs, e.served, e.reason, e.replanned) for e in got.epochs] == [
        (e.jobs, e.served, e.reason, e.replanned) for e in want.epochs]
    assert [(t.admitted, t.met) for t in got.report.tenants] == [
        (t.admitted, t.met) for t in want.report.tenants]
    done = [t for t in got.report.tenants if t.admitted]
    assert np.allclose([t.t_complete for t in done],
                       [t.t_complete for t in want.report.tenants if t.admitted],
                       rtol=PARITY_RTOL, atol=PARITY_ATOL)
    g = run_ordering_baseline(stream, cluster, "rr", policy="fifo", device=cuda)
    w = run_ordering_baseline(stream, cluster, "rr", policy="fifo", device="cpu")
    assert np.allclose([t.t_complete for t in g.tenants], [t.t_complete for t in w.tenants],
                       rtol=PARITY_RTOL, atol=PARITY_ATOL)
    assert g.deadlines_met == w.deadlines_met


@pytest.mark.cuda
def test_joint_search_matches_cpu(cuda):
    """Multi-job ETP under fifo (waterfill's rates) on the card: the same
    winner and best cost as on the CPU, and per-job makespans."""
    from repro_torch.core import simulate_torch
    from repro_torch.core.multijob import joint_search, per_job_makespans, realize_merged

    jobs = [_compute_job(4), build_gnn_workload(
        n_stores=2, n_workers=2, samplers_per_worker=2, n_ps=1, n_iters=3,
        store_to_sampler_gb=1.0, sampler_to_worker_gb=0.5, grad_gb=0.2,
        store_exec_s=0.3, sampler_exec_s=0.4, worker_exec_s=0.8,
        ps_exec_s=0.2, pmr=1.3)]
    cluster = heterogeneous_cluster(4, seed=3, gpu_range=(2, 4))
    kw = dict(n_chains=2, budget=8, seed=0, policy="fifo", sim_iters=3)
    before = waterfill_fill.launches
    mj, got = joint_search(jobs, cluster, device=cuda, **kw)
    assert waterfill_fill.launches > before
    _, want = joint_search(jobs, cluster, device="cpu", **kw)
    assert np.array_equal(got.placement.y, want.placement.y)
    assert np.isclose(got.best_makespan, want.best_makespan, rtol=PARITY_RTOL,
                      atol=PARITY_ATOL)
    r = realize_merged(mj, seed=0)
    spans = [per_job_makespans(mj, simulate_torch(mj.workload, cluster, got.placement, r,
                                                  policy="fifo", record=True, device=d))
             for d in (cuda, "cpu")]
    assert np.allclose(spans[0], spans[1], rtol=PARITY_RTOL, atol=PARITY_ATOL)


@pytest.mark.cuda
def test_cache_aware_etp_matches_cpu(cuda):
    """Cache-aware ETP (prefetch buffers, a binding reservation) under oes
    and fifo on the card: the same winner and best cost as on the CPU."""
    from repro_torch.cache import CacheConfig, build_hit_model, cache_aware_etp, collect_trace

    trace = collect_trace(synthetic_graph(n_nodes=2000, avg_degree=12, n_feats=16,
                                          n_parts=4, seed=0),
                          n_samplers=8, seeds_per_iter=16, fanouts=(4, 4), n_iters=12)
    wl = build_gnn_workload(
        n_stores=4, n_workers=4, samplers_per_worker=2, n_ps=1, n_iters=10,
        store_to_sampler_gb=0.8, sampler_to_worker_gb=0.05, grad_gb=0.01,
        store_exec_s=0.02, sampler_exec_s=0.04, worker_exec_s=0.06,
        ps_exec_s=0.01, store_skew=[0.1, 0.1, 0.7, 0.1],
    )
    from repro_torch.core import testbed_cluster

    cluster = testbed_cluster()
    model = build_hit_model(trace, policy="prefetch", capacity_nodes=150)
    for policy in ("oes", "fifo"):
        kw = dict(n_chains=4, budget=16, sim_iters=6, seed=0, policy=policy)
        cfg = CacheConfig(policy="prefetch", cache_gb=1.0)
        got = cache_aware_etp(wl, cluster, model, cfg, device=cuda, **kw)
        want = cache_aware_etp(wl, cluster, model, cfg, device="cpu", **kw)
        assert np.array_equal(got.placement.y, want.placement.y), policy
        assert np.isclose(got.best_makespan, want.best_makespan, rtol=PARITY_RTOL,
                          atol=PARITY_ATOL)


def _sage_inputs(seed, n, f, m, k):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, f)).astype(np.float32)
    idx = rng.integers(-1, n, (m, k)).astype(np.int32)
    idx[1] = -1  # an all-padding row
    return x, idx


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,f,m,k,misalign", [
    (500, 64, 128, 8, False),
    (300, 128, 64, 16, False),
    (1000, 100, 1037, 15, False),  # F = 100 (wide fp32, narrow bf16); odd M
    (400, 30, 77, 40, False),  # F not a multiple of 4; K > 32
    (600, 256, 300, 5, True),  # x not 16-byte aligned: narrow path
    (700, 256, 250, 10, False),  # F = 256: 16-byte accesses in both dtypes
    (90, 7, 500, 6, False),  # F = 7: 4-byte (fp32) and 2-byte (bf16) accesses
    (1000, 100, 333, 15, True),  # F = 100 misaligned: 4-byte / 2-byte accesses
    (50, 100, 40, 200, False),  # K = 200: 13 rounds of 16 ids a tile
    (300, 1100, 70, 4, False),  # F = 1100: column chunks and a short last
])
def test_sage_kernel_matches_plain(cuda, n, f, m, k, misalign, dtype):
    """The aggregation kernel equals its plain version bit for bit in
    fp32 (same j order, IEEE division); bf16 within 3e-2."""
    x, idx = _sage_inputs(17, n, f, m, k)
    dt = getattr(torch, dtype)
    if misalign:
        flat = torch.from_numpy(x).reshape(-1).to(cuda, dt)
        xt = torch.empty(n * f + 1, dtype=dt, device=cuda)[1:].copy_(flat).reshape(n, f)
        assert xt.data_ptr() % 16 != 0
    else:
        xt = torch.from_numpy(x).to(cuda, dt)
    it = torch.from_numpy(idx).to(cuda)
    before = sage_aggregate.launches
    got = sage_aggregate(xt, it)
    torch.cuda.synchronize()
    assert sage_aggregate.launches == before + 1
    want = sage_aggregate_plain(xt, it)
    assert got.dtype == dt
    if dtype == "float32":
        assert torch.equal(got, want)
    else:
        assert (got.float() - want.float()).abs().max().item() <= 3e-2
    assert (got[1] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,f,k,misalign,vec", [
    ("float32", 100, 15, False, 16),
    ("float32", 256, 10, False, 16),
    ("float32", 256, 40, False, 16),  # three rounds of 16 ids a tile
    ("bfloat16", 256, 5, False, 16),
    ("bfloat16", 100, 15, False, 8),  # 200-byte rows: 8 bytes a lane
    ("float32", 7, 15, False, 4),
    ("float32", 256, 15, True, 4),
])
def test_sage_kernel_access(cuda, dtype, f, k, misalign, vec):
    """The forward at the access width its plan names equals the plain
    version (bit for bit in fp32, within 3e-2 in bf16) and itself on a
    second run; the gather probe (its loads alone) launches at the same
    plan and is not counted."""
    dt = getattr(torch, dtype)
    x, idx = _sage_inputs(21, 800, f, 600, k)
    xt = torch.from_numpy(x).to(cuda, dt)
    if misalign:
        xt = torch.empty(xt.numel() + 1, dtype=dt, device=cuda)[1:].copy_(
            xt.reshape(-1)).reshape(xt.shape)
    it = torch.from_numpy(idx).to(cuda)
    assert forward_plan(f, xt.element_size(), xt.data_ptr()).vec_bytes == vec
    before = sage_aggregate.launches
    got = sage_aggregate(xt, it)
    again = sage_aggregate(xt, it)
    gather_probe(xt, it)
    torch.cuda.synchronize()
    assert sage_aggregate.launches == before + 2
    want = sage_aggregate_plain(xt, it)
    assert torch.equal(got, again)
    if dtype == "float32":
        assert torch.equal(got, want)
    else:
        assert (got.float() - want.float()).abs().max().item() <= 3e-2


def _backward_inputs(seed, n, f, m, k):
    x, idx = _sage_inputs(seed, n, f, m, k)
    rng = np.random.default_rng(seed + 1)
    idx[2] = 3  # one id repeated across a whole row
    idx[5:60:3, 0] = 7  # and one id named by 19 rows
    idx[idx >= n - 50] = -1  # the last 50 rows are named by no id
    go = rng.standard_normal((m, f)).astype(np.float32)
    return idx, go


@pytest.mark.cuda
@pytest.mark.parametrize("n,f,m,k", [
    (500, 64, 128, 8),
    (25071 // 8, 256, 6716 // 8, 10),  # layer 1's widths, an eighth of its rows
    (900, 256, 300, 5),  # layer 2's fan-out
    (400, 30, 77, 40),  # F not a multiple of 4; K > 32
    (300, 100, 1037, 15),  # F = 100; odd M
])
def test_sage_backward_matches_cpu(cuda, n, f, m, k):
    """The backward kernels equal the plain backward on the CPU bit for bit
    in fp32 (the segment sum adds in ascending flat position, as the CPU's
    index_add_ does), give the same bits on a second run, and sync nothing
    with the host."""
    idx, go = _backward_inputs(31, n, f, m, k)
    want = sage_aggregate_backward_plain(torch.from_numpy(go), torch.from_numpy(idx), n)
    go_t, idx_t = torch.from_numpy(go).to(cuda), torch.from_numpy(idx).to(cuda)
    torch.cuda.synchronize()
    before = sage_aggregate.backward_launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = sage_aggregate_backward(go_t, idx_t, n)
        again = sage_aggregate_backward(go_t, idx_t, n)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert sage_aggregate.backward_launches == before + 2
    assert got.dtype == torch.float32 and got.shape == (n, f)
    assert torch.equal(got, again)
    assert torch.equal(got.cpu(), want)
    assert (got[n - 50:] == 0).all()


@pytest.mark.cuda
def test_sage_backward_long_segment(cuda):
    """A row named by 1000 ids (a segment that a block sorts and sums)
    equals the CPU bit for bit."""
    n, f, m, k = 64, 256, 400, 5
    idx, go = _backward_inputs(41, n, f, m, k)
    idx[:200, :] = 9
    want = sage_aggregate_backward_plain(torch.from_numpy(go), torch.from_numpy(idx), n)
    got = sage_aggregate_backward(torch.from_numpy(go).to(cuda),
                                  torch.from_numpy(idx).to(cuda), n)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_sage_backward_hubs(cuda):
    """Three hubs each named by a third of 12000 output rows (segments of
    4000 positions, as a power-law graph's hubs give) beside short
    segments: equal to the CPU bit for bit, and the same bits again."""
    n, f, m, k = 3000, 256, 12000, 5
    idx, go = _backward_inputs(43, n, f, m, k)
    idx[:, 0] = np.arange(m) % 3
    want = sage_aggregate_backward_plain(torch.from_numpy(go), torch.from_numpy(idx), n)
    go_t, idx_t = torch.from_numpy(go).to(cuda), torch.from_numpy(idx).to(cuda)
    got = sage_aggregate_backward(go_t, idx_t, n)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(sage_aggregate_backward(go_t, idx_t, n), got)


@pytest.mark.cuda
def test_sage_backward_giant_segment(cuda):
    """A row named 24000 times (sorted by a bitmap in shared memory and
    streamed through the ring 48 rows a stage) equals the CPU bit for
    bit."""
    n, f, m, k = 500, 64, 12000, 3
    idx, go = _backward_inputs(47, n, f, m, k)
    idx[:, :2] = 5
    want = sage_aggregate_backward_plain(torch.from_numpy(go), torch.from_numpy(idx), n)
    got = sage_aggregate_backward(torch.from_numpy(go).to(cuda),
                                  torch.from_numpy(idx).to(cuda), n)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_sage_backward_without_bitmap(cuda):
    """840000 flat positions, too many for the sort's bitmap in shared
    memory (long_plan): long segments are sorted in device memory, and
    still equal the CPU bit for bit, with F = 7 (4-byte copies)."""
    n, f, m, k = 100000, 7, 280000, 3
    idx, go = _backward_inputs(53, n, f, m, k)
    idx[::2800, 2] = 11  # a row named 100 times
    assert not long_plan(f, m * k)[1]
    want = sage_aggregate_backward_plain(torch.from_numpy(go), torch.from_numpy(idx), n)
    got = sage_aggregate_backward(torch.from_numpy(go).to(cuda),
                                  torch.from_numpy(idx).to(cuda), n)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_sage_autograd_on_card(cuda):
    """Autograd through the forward kernel runs the backward kernels: the
    gradient in x equals the CPU's bit for bit, both counters advance."""
    x, idx = _sage_inputs(51, 600, 256, 200, 10)
    w = np.random.default_rng(52).standard_normal((200, 256)).astype(np.float32)
    grads = []
    for dev in ("cpu", cuda):
        xt = torch.from_numpy(x).to(dev).requires_grad_(True)
        before = (sage_aggregate.launches, sage_aggregate.backward_launches)
        (sage_aggregate(xt, torch.from_numpy(idx).to(dev))
         * torch.from_numpy(w).to(dev)).sum().backward()
        moved = (sage_aggregate.launches - before[0],
                 sage_aggregate.backward_launches - before[1])
        assert moved == ((0, 0) if dev == "cpu" else (1, 1))
        grads.append(xt.grad.cpu())
    assert torch.equal(grads[0], grads[1])


@pytest.mark.cuda
def test_graphsage_on_card_matches_cpu(cuda):
    """One forward and backward on the card (three forward and two backward
    launches: layer 0's input needs no gradient) against the same on the
    CPU (the plain versions): loss and every gradient within 1e-4 (cuBLAS
    and the CPU's BLAS sum the products in other orders)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = synthetic_graph(n_nodes=3000, n_parts=4, seed=0)
    rng = np.random.default_rng(0)
    seeds = rng.choice(g.train_nodes, 128, replace=False)
    feats, blocks, labels, _ = sample_blocks(g, seeds, (5, 10, 15), rng)
    cfg = SageConfig(in_dim=100, hidden=64, n_classes=47, n_layers=3)
    on_card = GraphSAGE(cfg, device=cuda, seed=0)
    on_cpu = GraphSAGE(cfg, device="cpu", seed=0)
    before = sage_aggregate.launches
    before_bwd = sage_aggregate.backward_launches
    loss_g, _ = sage_loss(on_card, batch_to(feats, blocks, labels, device=cuda))
    loss_g.backward()
    assert sage_aggregate.launches == before + 3
    assert sage_aggregate.backward_launches == before_bwd + 2
    loss_c, _ = sage_loss(on_cpu, batch_to(feats, blocks, labels, device="cpu"))
    loss_c.backward()
    assert abs(loss_g.item() - loss_c.item()) < 1e-4
    for pg, pc in zip(on_card.parameters(), on_cpu.parameters()):
        assert (pg.grad.cpu() - pc.grad).abs().max().item() < 1e-4


def _family_inputs(cfg, gen, seq=32, b=2):
    """Seeded CPU inputs of a smoke config's frontend (32 positions, a
    patch prefix included): (tokens or None, keyword inputs)."""
    if cfg.frontend == "frames":
        return None, {"frames": torch.randn(b, seq, cfg.d_model, generator=gen)}
    n_patch = cfg.n_patches if cfg.frontend == "patches" else 0
    toks = torch.randint(0, cfg.vocab, (b, seq - n_patch), generator=gen)
    kw = {"patches": torch.randn(b, n_patch, cfg.d_model, generator=gen)} if n_patch else {}
    return toks, kw


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma2-27b", "zamba2-7b", "hubert-xlarge",
                                  "llava-next-mistral-7b"])
def test_family_on_card_matches_cpu(cuda, arch):
    """A smoke model of the last four families in fp32 on the card
    (the kernels) against the same weights on the CPU (the plain
    versions): hidden states, prefill logits and, except for the encoder,
    24 decode steps at smax 32 (past the smoke windows of 16) within 1e-4;
    the forward launches flash once per attention layer or shared-block
    application and ssd_scan once per mamba2 layer."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models import TransformerLM

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    on_cpu = TransformerLM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    on_card = TransformerLM(cfg, device=cuda)
    on_card.load_state_dict(on_cpu.state_dict())
    toks, kw = _family_inputs(cfg, torch.Generator().manual_seed(1))
    if cfg.block_pattern == "zamba2":
        want = (cfg.n_layers // cfg.hybrid_every, cfg.n_layers)
    else:
        want = (cfg.n_layers, 0)
    before = (flash_attention.launches, ssd_scan.launches)
    h_card = on_card.forward(None if toks is None else toks.to(cuda),
                             **{k: v.to(cuda) for k, v in kw.items()})
    torch.cuda.synchronize()
    assert (flash_attention.launches - before[0], ssd_scan.launches - before[1]) == want
    h_cpu = on_cpu.forward(toks, **kw)
    assert (h_card.cpu() - h_cpu).abs().max().item() < 1e-4
    l_card = on_card._logits(h_card[:, -1]).cpu()[:, : cfg.vocab]
    l_cpu = on_cpu._logits(h_cpu[:, -1])[:, : cfg.vocab]
    assert (l_card - l_cpu).abs().max().item() < 1e-4
    if cfg.is_encoder:
        with pytest.raises(ValueError, match="encoder"):
            on_card.cache_struct(2, 32)
        return
    steps = torch.randint(0, cfg.vocab, (2, 24), generator=torch.Generator().manual_seed(2))
    c_card, c_cpu = on_card.cache_struct(2, 32), on_cpu.cache_struct(2, 32)
    for t in range(24):
        before = flash_attention.launches
        c_card, g = on_card.decode_step(c_card, steps[:, t].to(cuda), t)
        assert flash_attention.launches - before == want[0]
        c_cpu, w = on_cpu.decode_step(c_cpu, steps[:, t], t)
        assert (g.cpu() - w)[:, : cfg.vocab].abs().max().item() < 1e-4, t


# the MN-major B descriptor's offsets: the two 64-column halves of the
# [128, 128] B tile are 128 rows of 128 bytes apart; 8-row groups 1024
PROBE_LBO, PROBE_SBO = 128 * 128, 1024


def _probe():
    path, _, _ = _build.build(_build.BUILD_DIR.parent / "src" / "repro_torch" / "kernels"
                              / "csrc" / "wgmma_probe.cu")[0]
    lib = ctypes.CDLL(str(path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.repro_wgmma_probe.argtypes = [vp, vp, vp, ci, ci, ci, vp]
    lib.repro_wgmma_probe.restype = ci
    return lib.repro_wgmma_probe


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_wgmma_probe_matches_matmul(cuda, mode):
    """One m64nNk16 chain over K = 128 (two 64-column halves of the
    128-byte swizzle) on TMA-loaded bf16 tiles: mode 0 with a K-major B
    (attention's scores), 1 with an MN-major B (the grouped GEMM), 2 with
    A from registers and an MN-major B (attention's P V), 3 with an
    MN-major A (the transpose flag of A: the grouped GEMM's dw = x^T dy).
    Products of bf16 values are exact in fp32; only the order of the sums
    differs."""
    rng = np.random.default_rng(mode)
    a = torch.from_numpy(rng.standard_normal((128, 64) if mode == 3 else (64, 128))).to(
        cuda, torch.bfloat16)
    b = torch.from_numpy(rng.standard_normal((64 if mode == 0 else 128, 128))).to(
        cuda, torch.bfloat16)
    want = (a.float().T if mode == 3 else a.float()) @ (b.float().T if mode == 0 else b.float())
    out = torch.full(want.shape, float("nan"), device=cuda)
    err = _probe()(a.data_ptr(), b.data_ptr(), out.data_ptr(), mode, PROBE_LBO, PROBE_SBO,
                   torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    assert (out - want).abs().max().item() < 1e-3


@pytest.mark.cuda
def test_one_rank_mesh_step_on_card_equals_no_mesh():
    """The one-rank NCCL mesh (data 1, model 1) on the card: two AdamW
    steps of a narrow fp32 internlm2 equal the no-mesh steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    code = (
        "import dataclasses, torch\n"
        "from repro_torch import configs\n"
        "from repro_torch.models import TransformerLM\n"
        "from repro_torch.launch.mesh import init_ranks, make_host_mesh\n"
        "from repro_torch.sharding import ctx_for_mesh\n"
        "from repro_torch.train import AdamWSettings, TrainStepBuilder\n"
        "cfg = dataclasses.replace(configs.get_config('internlm2-1.8b'), n_layers=2,"
        " d_model=256, n_heads=4, n_kv_heads=2, d_ff=512, vocab=1000, dtype='float32')\n"
        "init_ranks('cuda')\n"
        "ctx = ctx_for_mesh(make_host_mesh())\n"
        "g = torch.Generator(device='cuda').manual_seed(3)\n"
        "batch = {k: torch.randint(0, 1000, (2, 256), generator=g, device='cuda')"
        ".int() for k in ('tokens', 'labels')}\n"
        "out = []\n"
        "for mesh in (False, True):\n"
        "    m = TransformerLM(cfg, device='cuda').init(torch.Generator(device='cuda')"
        ".manual_seed(0))\n"
        "    if mesh: m.shard_parameters(ctx)\n"
        "    b = TrainStepBuilder(m, AdamWSettings(lr=1e-3, warmup_steps=0))\n"
        "    st = b.init_state()\n"
        "    out.append([float(b.train_step(st, batch)[1]['loss']) for _ in range(2)])\n"
        "assert all(abs(a - c) <= 1e-6 * abs(c) for a, c in zip(*out)), out\n"
        "print('ok')\n"
    )
    import os
    import subprocess
    import sys
    from pathlib import Path

    src = Path(__file__).resolve().parents[1] / "src"
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": str(src)})
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stderr[-3000:]
