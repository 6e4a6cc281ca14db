"""The torch engine on a CUDA card against the same engine on the CPU.

Marked ``cuda``: every test skips without a card (the engine's fifo and
mrtf rates launch a CUDA kernel, which has no CPU mode).  On a machine
with one, run the card's tests (this file and the waterfill kernel's):

    python -m pytest -m cuda tests/test_torch_cuda.py tests/test_torch_waterfill.py

This file imports torch, numpy and the port only, so it runs where JAX
is absent.
"""
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
from repro_torch.kernels.waterfill import waterfill_fill

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("policy", ("oes", "oes_strict", "fifo", "mrtf", "omcoflow"))
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
