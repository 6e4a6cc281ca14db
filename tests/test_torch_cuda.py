"""The port on a CUDA card against the same port on the CPU.

The torch engine, the GraphSAGE aggregation kernel against its plain
version, GraphSAGE's forward and backward, and the wgmma probe
(``csrc/wgmma_probe.cu``: one block of m64nNk16 products through the
helpers of ``csrc/sm90.cuh`` against ``torch.matmul``).  Marked ``cuda``:
those tests skip without a card (the engine's fifo and mrtf rates and
the kernels have no CPU mode).  One CPU test: a library's digest covers
the headers its source includes.  On a machine with a card, run the
card's tests (this file and the waterfill kernel's):

    python -m pytest -m cuda tests/test_torch_cuda.py tests/test_torch_waterfill.py

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
from repro_torch.kernels.sage_aggregate import sage_aggregate, sage_aggregate_plain
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
def test_graphsage_on_card_matches_cpu(cuda):
    """One forward and backward on the card (three kernel launches) against
    the same on the CPU (the plain version): loss and every gradient within
    1e-4 (the backward's index_add_ sums in atomic order on the card)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = synthetic_graph(n_nodes=3000, n_parts=4, seed=0)
    rng = np.random.default_rng(0)
    seeds = rng.choice(g.train_nodes, 128, replace=False)
    feats, blocks, labels, _ = sample_blocks(g, seeds, (5, 10, 15), rng)
    cfg = SageConfig(in_dim=100, hidden=64, n_classes=47, n_layers=3)
    on_card = GraphSAGE(cfg, device=cuda, seed=0)
    on_cpu = GraphSAGE(cfg, device="cpu", seed=0)
    before = sage_aggregate.launches
    loss_g, _ = sage_loss(on_card, batch_to(feats, blocks, labels, device=cuda))
    loss_g.backward()
    assert sage_aggregate.launches == before + 3
    loss_c, _ = sage_loss(on_cpu, batch_to(feats, blocks, labels, device="cpu"))
    loss_c.backward()
    assert abs(loss_g.item() - loss_c.item()) < 1e-4
    for pg, pc in zip(on_card.parameters(), on_cpu.parameters()):
        assert (pg.grad.cpu() - pc.grad).abs().max().item() < 1e-4


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
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_wgmma_probe_matches_matmul(cuda, mode):
    """One m64nNk16 chain over K = 128 (two 64-column halves of the
    128-byte swizzle) on TMA-loaded bf16 tiles: mode 0 with a K-major B
    (attention's scores), 1 with an MN-major B (the grouped GEMM), 2 with
    A from registers and an MN-major B (attention's P V).  Products of
    bf16 values are exact in fp32; only the order of the sums differs."""
    rng = np.random.default_rng(mode)
    a = torch.from_numpy(rng.standard_normal((64, 128))).to(cuda, torch.bfloat16)
    b = torch.from_numpy(rng.standard_normal((64 if mode == 0 else 128, 128))).to(
        cuda, torch.bfloat16)
    want = a.float() @ (b.float().T if mode == 0 else b.float())
    out = torch.full(want.shape, float("nan"), device=cuda)
    err = _probe()(a.data_ptr(), b.data_ptr(), out.data_ptr(), mode, PROBE_LBO, PROBE_SBO,
                   torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    assert (out - want).abs().max().item() < 1e-3
