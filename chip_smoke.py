#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py        # on a machine with one CUDA card

Drives the port's three paths on the card, DGTP planning, GraphSAGE
training and LM serving, and holds them against the port's own CPU path
and against the plain version of every kernel.  Phases, in order; any
failure ends the run with a non-zero exit:

  1. build the three kernels (waterfill, sage_aggregate, flash_attention) from
     ``src/repro_torch/kernels/csrc`` with nvcc for sm_90a, one nvcc per
     source, all started together;
  2. the kernel against its plain version on the card, at every shape
     the main path gives it (B=1024 with EG=1400, M=16 and with EG=72,
     M=4; B=1 with EG=72, M=4), on inputs with tied priority keys: exact
     equality, and times;
  3. ``simulate_batch_torch`` at width 1024 on the papers100M job (J=117,
     E=1400, M=16) and the products job (J=23, E=72, M=4), all five
     policies, on the card; the first 8 instances are held against the
     same 8 on the CPU (run in worker processes meanwhile, compared once
     phase 4 is done) at the engine's parity tolerance;
  4. ``plan()`` on the quickstart job and cluster (budget 600, 15
     simulated iterations, seed 0) and ``plan_baseline("distdgl")``, each
     committed schedule held against the CPU engine;
  5. a profiled short run per job (the device's busy share, the kernel
     launches per iteration, the top device rows);
  6. GraphSAGE at the ogbn-products widths (in 100, hidden 256, 47
     classes, 3 layers, fan-outs 5/10/15, 2000 seeds per batch) on a
     240,000-node synthetic graph: the aggregation kernel against its
     plain version at the three shapes one batch gives it (exact in
     fp32, 3e-2 in bf16, plus all-padding rows and an odd M), with
     times beside its bound and ``F.embedding_bag``; one forward and
     backward on the card against the same on the CPU; then five SGD
     steps, the measured-traffic calibration and
     ``plan_baseline("distdgl")`` (its fifo commit launches waterfill);
     then one profiled step (the device's busy share);
  7. LM serving (internlm2-1.8b, bf16, random weights from a seeded
     generator on the card): the attention kernel against its plain
     version at the five sweep shapes of ``tests/test_kernels.py``, the
     prefill shape q [4, 16, 2048, 128] over 8 KV heads and the decode
     shape q [8, 16, 1, 128] against a [8, 2048, 8, 128] cache at three
     positions (fp32 within 2e-5, bf16 within 2e-2), with times beside
     its bound and ``F.scaled_dot_product_attention``; ``prefill`` of
     4 x 2048 tokens through the kernel against the same with the plain
     attention; 2 layers at full width in fp32 on the card against the
     CPU, and decode against forward; decode against forward at full
     depth in bf16; then ``ServeEngine`` (16 requests, 8 slots, smax
     2048, 128 new tokens each) and one profiled tick;
  8. the kernel table's JSON line, the card's name and power limit, and
     the closing status line.

Three main paths, each with the kernel launch counts set to 0 just
before it and read just after: phases 3-4 (planning), the training
steps, calibration and baseline plan of phase 6 (GraphSAGE), and the
``ServeEngine`` run of phase 7 (LM serving).  Each phase's seconds are
printed on a ``[time]`` line.  ``--only lm_serve`` builds the kernels
and runs phase 7 alone (for work on that path; it prints no closing
status line).  Imports nothing of JAX or of the ``repro`` package.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

POLICIES = ("oes", "oes_strict", "fifo", "mrtf", "omcoflow")
WIDTH = 1024
N_CHECK = 8  # instances held against the CPU engine
# worker processes for the CPU references; they run while the card works
CPU_WORKERS = 6
# H100 SXM data sheet: HBM3 bandwidth and the fp64 and fp32 (non-tensor) peaks
HBM_BYTES_PER_S = 3.35e12
FP64_FLOP_PER_S = 34e12
FP32_FLOP_PER_S = 67e12
# GraphSAGE phase: the ogbn-products widths (core/profiles.py, and the
# reference's SageConfig defaults) and the paper's per-worker mini-batch;
# the graph is cut from ogbn-products' 2.4M nodes to 240k (a batch's
# support barely grows past this size, and building it costs host time)
SAGE_NODES = 240_000
SAGE_BATCH = 2000
SAGE_FANOUTS = (5, 10, 15)
SAGE_STEPS = 5
SAGE_ATOL = 1e-4  # card against CPU: logits, loss and gradients
BF16_ATOL = 3e-2  # the JAX package's kernel sweep tolerance for bf16
# LM serving phase: the default arch of launch/serve.py at full width
LM_ARCH = "internlm2-1.8b"
LM_PREFILL = (4, 2048)  # sequences, tokens
LM_REQUESTS, LM_SLOTS, LM_SMAX, LM_MAX_TOKENS = 16, 8, 2048, 128
# the attention sweep of tests/test_kernels.py and its tolerances
FLASH_SWEEP = [  # (b, h, sq, sk, d, causal, window, softcap)
    (1, 2, 256, 256, 64, True, None, None),
    (2, 1, 128, 256, 128, True, 64, None),
    (1, 2, 256, 256, 64, True, None, 30.0),
    (1, 1, 128, 128, 64, False, None, None),
    (2, 2, 384, 384, 32, True, 128, 50.0),
]
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DECODE_POSITIONS = (0, 1023, 2047)
BF16_FLOP_PER_S = 989e12  # H100 SXM, dense tensor cores
# 2 layers at full width in fp32, card against CPU: only the order of the
# sums differs (cuBLAS and the kernel against the CPU's BLAS and the plain
# version), ~1e-6 relative in fp32; 1e-3 on values of order 1-10 leaves
# room for the 2048- and 8192-long dot products over 2 layers
LM_FP32_ATOL = 1e-3


def _jobs():
    """(name, workload, cluster): the paper's simulation-study job and its
    testbed job (benchmarks/bench_algorithms.py, examples/quickstart.py)."""
    from repro_torch.core import (
        OGBN_PAPERS100M,
        OGBN_PRODUCTS,
        build_workload_from_profile,
        heterogeneous_cluster,
        testbed_cluster,
    )

    papers = build_workload_from_profile(
        OGBN_PAPERS100M, n_stores=16, n_workers=20, samplers_per_worker=4,
        n_ps=1, n_iters=10,
    )
    products = build_workload_from_profile(
        OGBN_PRODUCTS, n_stores=4, n_workers=6, samplers_per_worker=2,
        n_ps=1, n_iters=40,
    )
    return [
        ("papers", papers, heterogeneous_cluster(16, seed=1)),
        ("products", products, testbed_cluster()),
    ]


def _candidates(wl, cluster, width, seed):
    """ETP-style candidate placements: the DistDGL placement and two IFS
    starts, each with 1-4 random non-store tasks moved to random machines
    (seeded), paired with the seeded draws realize(seed=b)."""
    from repro_torch.core import Placement, distdgl_placement, ifs_placement

    rng = np.random.default_rng(seed)
    bases = [distdgl_placement(wl, cluster)] + [
        ifs_placement(wl, cluster, seed=s) for s in (0, 1)
    ]
    movable = np.array(
        [j for j, t in enumerate(wl.tasks) if t.kind != "store"]
    )
    ys = []
    for b in range(width):
        y = bases[b % len(bases)].y.copy()
        if b >= len(bases):
            moved = rng.choice(movable, size=int(rng.integers(1, 5)), replace=False)
            y[moved] = rng.integers(0, cluster.M, size=len(moved))
        ys.append(y)
    placements = [Placement(y) for y in ys]
    reals = [wl.realize(seed=b) for b in range(width)]
    return placements, reals


def _cpu_reference(job, policy, ys, vols, exs):
    """Worker process: the first instances on the CPU engine."""
    import torch

    from repro_torch.core import Placement, Realization, simulate_batch_torch

    torch.set_num_threads(1)
    wl, cluster = {n: (w, c) for n, w, c in _jobs()}[job]
    res = simulate_batch_torch(
        wl, cluster, [Placement(y) for y in ys],
        [Realization(v, e) for v, e in zip(vols, exs)],
        policy=policy, record=True, device="cpu",
    )
    N = vols[0].shape[1]
    return (
        [r.makespan for r in res],
        np.stack([r.task_start_matrix(wl.J, N) for r in res]),
    )


def _assert_parity(name, ms_gpu, st_gpu, ms_cpu, st_cpu):
    from repro_torch.core import PARITY_ATOL, PARITY_RTOL

    ok_ms = np.allclose(ms_gpu, ms_cpu, rtol=PARITY_RTOL, atol=PARITY_ATOL)
    ok_st = np.allclose(st_gpu, st_cpu, rtol=PARITY_RTOL, atol=PARITY_ATOL,
                        equal_nan=True)
    if not (ok_ms and ok_st):
        raise AssertionError(
            f"{name}: cuda and cpu engines disagree "
            f"(makespans {ms_gpu} vs {ms_cpu})"
        )
    return float(np.max(np.abs(np.asarray(ms_gpu) - np.asarray(ms_cpu))))


def _waterfill_inputs(seed, B, EG, M):
    """Seeded kernel inputs with many tied priority keys (integer keys in
    [0, 4), stably sorted), random eligibility and some exhausted NICs."""
    rng = np.random.default_rng(seed)
    key = rng.integers(0, 4, size=(B, EG)).astype(np.float64)
    order = np.argsort(key, axis=1, kind="stable").astype(np.int32)
    src = rng.integers(0, M, size=(B, EG)).astype(np.int32)
    dst = rng.integers(0, M, size=(B, EG)).astype(np.int32)
    elig = rng.random((B, EG)) < 0.7
    cap_in = rng.uniform(0.0, 3.0, size=(B, M))
    cap_out = rng.uniform(0.0, 3.0, size=(B, M))
    cap_in[rng.random((B, M)) < 0.2] = 0.0
    return order, src, dst, elig, cap_in, cap_out


def _cuda_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _kernel_shapes():
    """(label, B, EG, M) of every waterfill launch on the main path: the
    engine at width 1024 on each job, and the width-1 DistDGL commit
    (fifo) on the products job."""
    shapes = [(job, WIDTH, wl.E, cl.M) for job, wl, cl in _jobs()]
    _, wl, cl = _jobs()[1]
    return shapes + [("products commit", 1, wl.E, cl.M)]


def phase_kernel(wf):
    """The kernel against its plain version at each main-path shape, on
    seeded inputs with tied keys.  Returns the numbers of the first (the
    papers job's) shape and the largest difference over all of them."""
    import torch

    rows = []
    for seed, (label, B, EG, M) in enumerate(_kernel_shapes()):
        args = [torch.from_numpy(a).cuda()
                for a in _waterfill_inputs(seed, B, EG, M)]
        got = wf.waterfill_fill(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = wf.waterfill_fill_plain(*args)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        if not torch.equal(got, want):
            err = (got - want).abs().max().item()
            raise AssertionError(
                f"waterfill kernel != plain version at {label} (max {err})"
            )
        ms = _cuda_ms(lambda: wf.waterfill_fill(*args), 50)
        # least time for the same work: each input read once, the output
        # written once; operations counted on this data (two compares per
        # eligible flow, two subtractions per grant) at the fp64 peak
        n_bytes = B * EG * (3 * 4 + 1 + 8) + 2 * B * M * 8
        n_elig = int(args[3].sum().item())
        n_grant = int((want > 0).sum().item())
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = (2 * n_elig + 2 * n_grant) / FP64_FLOP_PER_S * 1e3
        print(
            f"[kernel] waterfill {label} B={B} EG={EG} M={M}: exact match; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.1f} ms, bound "
            f"{max(bytes_ms, ops_ms):.6f} ms ({n_bytes} bytes; dependent "
            f"chain {EG} steps per instance)",
            flush=True,
        )
        rows.append(dict(
            ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            max_abs_err=float((got - want).abs().max().item()),
        ))
    out = dict(rows[0])
    out["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    return out


def phase_engine(wf, pool):
    """The engine at width 1024 on the card.  The CPU references of the
    first instances are submitted to ``pool`` first, so that they run
    while the card works; returns the candidates and the pending
    comparisons for ``check_engine``."""
    import torch

    from repro_torch.core import simulate_batch_torch

    cands = {
        job: (wl, cluster, *_candidates(wl, cluster, WIDTH, seed=0))
        for job, wl, cluster in _jobs()
    }
    pending = []
    for job, (wl, cluster, placements, reals) in cands.items():
        ys = [p.y for p in placements[:N_CHECK]]
        vols = [r.volumes for r in reals[:N_CHECK]]
        exs = [r.exec_times for r in reals[:N_CHECK]]
        for policy in POLICIES:
            fut = pool.submit(_cpu_reference, job, policy, ys, vols, exs)
            pending.append((job, policy, fut))
    gpu = {}
    for job, (wl, cluster, placements, reals) in cands.items():
        print(f"[engine] {job}: J={wl.J} E={wl.E} M={cluster.M} "
              f"N={reals[0].n_iters} width={WIDTH}", flush=True)
        for policy in POLICIES:
            before = wf.waterfill_fill.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = simulate_batch_torch(
                wl, cluster, placements, reals, policy=policy, record=True,
                device="cuda",
            )
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = wf.waterfill_fill.launches - before
            iters = max(r.n_events for r in res)
            ms = np.array([r.makespan for r in res])
            if not (np.isfinite(ms).all() and (ms > 0).all()):
                raise AssertionError(f"{job}/{policy}: bad makespans")
            if policy in ("fifo", "mrtf") and launches == 0:
                raise AssertionError(f"{job}/{policy}: waterfill never launched")
            N = reals[0].n_iters
            gpu[(job, policy)] = (
                [r.makespan for r in res[:N_CHECK]],
                np.stack([r.task_start_matrix(wl.J, N) for r in res[:N_CHECK]]),
            )
            print(
                f"[engine] {job} {policy:10s} {WIDTH / wall:10.1f} evals/s "
                f"wall {wall:.2f} s, {iters} lock-step iterations "
                f"({iters / wall:.0f} it/s), mean makespan {ms.mean():.3f} s, "
                f"waterfill launches {launches}",
                flush=True,
            )
    return cands, pending, gpu


def check_engine(pending, gpu):
    """The card's first instances against the CPU engine's."""
    for job, policy, fut in pending:
        ms_cpu, st_cpu = fut.result()
        ms_gpu, st_gpu = gpu[(job, policy)]
        err = _assert_parity(f"{job}/{policy}", ms_gpu, st_gpu, ms_cpu, st_cpu)
        print(f"[engine] {job} {policy:10s} first {N_CHECK} instances match "
              f"the cpu engine (max makespan diff {err:.3g} s)", flush=True)


def phase_plan(wf):
    import torch

    from repro_torch.core import (
        OGBN_PRODUCTS,
        build_workload_from_profile,
        plan,
        plan_baseline,
        simulate_torch,
        testbed_cluster,
    )

    wl = build_workload_from_profile(
        OGBN_PRODUCTS, n_stores=4, n_workers=6, samplers_per_worker=2,
        n_ps=1, n_iters=40,
    )
    cluster = testbed_cluster()
    r = wl.realize(seed=0)
    before = wf.waterfill_fill.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p = plan(wl, cluster, realization=r, budget=600, sim_iters=15, seed=0,
             device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dd = plan_baseline(wl, cluster, baseline="distdgl", realization=r,
                       device="cuda")
    torch.cuda.synchronize()
    launches = wf.waterfill_fill.launches - before
    for name, pl, policy in (("dgtp", p, "oes"), ("distdgl", dd, "fifo")):
        ref = simulate_torch(wl, cluster, pl.placement, r, policy=policy,
                             record=True, device="cpu")
        _assert_parity(
            f"plan/{name}", [pl.schedule.makespan],
            pl.schedule.task_start_matrix(wl.J, r.n_iters)[None],
            [ref.makespan], ref.task_start_matrix(wl.J, r.n_iters)[None],
        )
    sp = 100 * (1 - p.schedule.makespan / dd.schedule.makespan)
    print(
        f"[plan] quickstart job: DGTP makespan {p.schedule.makespan:.3f} s, "
        f"DistDGL {dd.schedule.makespan:.3f} s, speedup {sp:.1f}%; planning "
        f"wall {wall:.1f} s ({p.etp.evaluations} evaluations, "
        f"{len(p.etp.chain_stats)} chains); waterfill launches {launches}; "
        f"both committed schedules match the cpu engine",
        flush=True,
    )


def _device_us(avg):
    return getattr(avg, "self_device_time_total", None) or getattr(
        avg, "self_cuda_time_total", 0.0
    )


def phase_profile(cands):
    """Where the engine's time goes: one short run per cell unprofiled,
    then the same run under torch.profiler.  Device time is summed over
    the profiler's device rows only (kernels and copies; an operator's
    row repeats the time of the kernels it launched), and set against
    both runs' wall times.  Not part of the main path (its launches are
    not counted)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import Realization, simulate_batch_torch

    for job, policy, n_iters in (("papers", "fifo", 1), ("products", "oes", 4)):
        wl, cluster, placements, reals = cands[job]
        short = [
            Realization(r.volumes[:, :n_iters], r.exec_times[:, :n_iters])
            for r in reals
        ]

        def run():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = simulate_batch_torch(wl, cluster, placements, short,
                                       policy=policy, device="cuda")
            torch.cuda.synchronize()
            return time.perf_counter() - t0, max(r.n_events for r in res)

        wall, iters = run()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall_p, _ = run()
        rows = sorted(
            (a for a in prof.key_averages() if a.device_type == DeviceType.CUDA),
            key=_device_us, reverse=True,
        )
        kernels = [a for a in rows if not a.key.startswith(("Memcpy", "Memset"))]
        dev_ms = sum(_device_us(a) for a in rows) / 1e3
        kern_ms = sum(_device_us(a) for a in kernels) / 1e3
        n_kernels = sum(a.count for a in kernels)
        print(
            f"[profile] {job} {policy} width {WIDTH}, {n_iters} iteration(s): "
            f"{iters} lock-step iterations, wall {wall:.3f} s unprofiled, "
            f"{wall_p:.3f} s profiled; device busy {dev_ms:.1f} ms "
            f"({kern_ms:.1f} ms in kernels), {100 * dev_ms / 1e3 / wall_p:.1f}% "
            f"of the profiled wall, {100 * dev_ms / 1e3 / wall:.1f}% of the "
            f"unprofiled; {n_kernels} kernel launches "
            f"({n_kernels / iters:.0f} per iteration)",
            flush=True,
        )
        for a in rows[:6]:
            print(f"[profile]   {_device_us(a) / 1e3:9.1f} ms {a.count:7d}x "
                  f"{a.key[:70]}", flush=True)


def _sage_x(batch_feats, blocks, hidden, seed):
    """(label, x, idx) of the three aggregations of one forward: layer 0
    gathers the batch's features, layers 1 and 2 the hidden rows (seeded
    ReLU'd normals of the shape the forward gives them)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    x = batch_feats
    L = len(blocks)
    for l in range(L):
        idx = blocks[L - 1 - l]
        out.append((f"layer {l}", x, idx))
        x = torch.relu(torch.randn(idx.shape[0], hidden, device="cuda",
                                   generator=gen))
    return out


def _device_ms(fn, reps, flush=False):
    """Device time per call, without the host's time to issue it: a spin
    kernel holds the card while the host enqueues every call between two
    events, so the calls then run back to back and the events time the
    device alone.  The spin must outlast the enqueueing (checked).  When
    it does not, the spin is lengthened and the calls halved: the card's
    launch queue holds a limited number of entries, and the host blocks
    once it is full (the plain version launches ~110 kernels a call).
    ``flush`` writes 128 MB before each call, outside its events, which
    evicts the 50 MB L2."""
    import torch

    buf = torch.empty(2**25, dtype=torch.float32, device="cuda") if flush else None
    fn()
    torch.cuda.synchronize()
    cycles = 10**7
    for _ in range(6):
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        torch.cuda._sleep(cycles)
        spun = torch.cuda.Event()
        spun.record()
        for t0, t1 in pairs:
            if flush:
                buf.fill_(1.0)
            t0.record()
            fn()
            t1.record()
        host_ahead = not spun.query()
        torch.cuda.synchronize()
        if host_ahead:
            return sum(t0.elapsed_time(t1) for t0, t1 in pairs) / reps
        cycles *= 4
        reps = max(1, reps // 2)
    raise AssertionError("the host could not enqueue the calls ahead of the card")


def phase_sage_kernel(sa, batch, hidden):
    """The aggregation kernel against its plain version at the three
    shapes one batch gives it: exact in fp32, BF16_ATOL in bf16; all-
    padding rows and an M that is not a multiple of 128; times beside the
    bound and beside ``F.embedding_bag``.  Returns the JSON numbers summed
    over the three shapes (one forward's aggregations)."""
    import torch
    import torch.nn.functional as F

    rows = []
    for label, x, idx in _sage_x(batch["feats"], batch["blocks"], hidden, 0):
        N, Fdim = x.shape
        M, K = idx.shape
        got = sa.sage_aggregate(x, idx)
        want = sa.sage_aggregate_plain(x, idx)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            err = (got - want).abs().max().item()
            raise AssertionError(f"sage kernel != plain at {label} (max {err})")
        xb = x.to(torch.bfloat16)
        err_bf16 = (sa.sage_aggregate(xb, idx).float()
                    - sa.sage_aggregate_plain(xb, idx).float()).abs().max().item()
        if not err_bf16 <= BF16_ATOL:
            raise AssertionError(f"sage kernel bf16 at {label}: max err {err_bf16}")
        # the yardstick: one PyTorch call with the same semantics
        bag_idx = torch.where(idx < 0, N, idx).long()
        bag_x = torch.cat([x, x.new_zeros(1, Fdim)])
        lib = lambda: F.embedding_bag(bag_idx, bag_x, mode="mean", padding_idx=N)
        err_lib = (lib() - want).abs().max().item()
        kernel = lambda: sa.sage_aggregate(x, idx)
        plain = lambda: sa.sage_aggregate_plain(x, idx)
        # device time per call with the 50 MB L2 flushed before each call
        # (x is 7-37 MB, so back-to-back calls find it in L2 and beat the
        # memory bound); the hot kernel time is printed beside it
        ms = _device_ms(kernel, 20, flush=True)
        hot_ms = _device_ms(kernel, 50)
        plain_ms = _device_ms(plain, 4, flush=True)
        library_ms = _device_ms(lib, 20, flush=True)
        call_ms = _cuda_ms(kernel, 50)
        lib_call_ms = _cuda_ms(lib, 50)
        # least time: idx read once, each distinct row of x that a valid
        # id names read once, the output written once; one add per
        # gathered value and one divide per output value at the fp32 peak
        valid = idx[idx >= 0]
        n_valid = valid.numel()
        n_rows = int(torch.unique(valid).numel())
        n_bytes = M * K * 4 + n_rows * Fdim * 4 + M * Fdim * 4
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = (n_valid * Fdim + M * Fdim) / FP32_FLOP_PER_S * 1e3
        bound = max(bytes_ms, ops_ms)
        print(
            f"[sage kernel] {label}: x {tuple(x.shape)} fp32, idx {tuple(idx.shape)} "
            f"({n_valid} valid ids, {n_rows} distinct rows): exact match, bf16 "
            f"max err {err_bf16:.3g}; device time per call, L2 flushed: kernel "
            f"{ms:.4f} ms (hot {hot_ms:.4f} ms), plain {plain_ms:.4f} ms, "
            f"embedding_bag {library_ms:.4f} ms (max diff {err_lib:.3g}); bound "
            f"{bound:.6f} ms ({n_bytes} bytes, {100 * bound / ms:.1f}% of the "
            f"kernel's time); back-to-back calls, host included: kernel "
            f"{call_ms:.4f} ms, embedding_bag {lib_call_ms:.4f} ms",
            flush=True,
        )
        rows.append(dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=bound, bytes_ms=bytes_ms, ops_ms=ops_ms,
                         max_abs_err=(got - want).abs().max().item()))
    # all-padding rows and an M that is not a multiple of 128
    x, idx = batch["feats"], batch["blocks"][-1][:1037].clone()
    idx[:64] = -1
    got = sa.sage_aggregate(x, idx)
    if not (torch.equal(got, sa.sage_aggregate_plain(x, idx))
            and (got[:64] == 0).all()):
        raise AssertionError("sage kernel: all-padding rows or odd M differ")
    print("[sage kernel] M=1037 with 64 all-padding rows: exact match, "
          "padding rows 0", flush=True)
    out = {k: sum(r[k] for r in rows) for k in ("ms", "plain_ms", "library_ms",
                                                  "bound_ms", "bytes_ms", "ops_ms")}
    out["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    out["bound_by"] = "bytes" if out["bytes_ms"] >= out["ops_ms"] else "operations"
    return out


def phase_sage(sa, wf):
    """GraphSAGE on the card: the kernel checks, card-vs-CPU parity, then
    the main path (training steps, calibration, DistDGL baseline plan)
    with the launch counts set to 0 just before and read just after, then
    one profiled step.  Returns the kernel numbers and the path's
    launches per kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import plan_baseline, testbed_cluster
    from repro_torch.core.units import BYTES_PER_GB, BYTES_PER_MIB
    from repro_torch.core.workload import build_gnn_workload
    from repro_torch.data.graph import sample_blocks, synthetic_graph
    from repro_torch.models import GraphSAGE, SageConfig, batch_to, sage_loss, sgd_step

    # full fp32 products on both sides of the card-vs-CPU comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = SageConfig(in_dim=100, hidden=256, n_classes=47, n_layers=3)
    t0 = time.perf_counter()
    g = synthetic_graph(n_nodes=SAGE_NODES, n_feats=cfg.in_dim,
                        n_classes=cfg.n_classes, n_parts=4, seed=0)
    print(f"[sage] graph: {g.n_nodes} nodes, {len(g.indices)} edges, "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(0)

    def sample():
        seeds = rng.choice(g.train_nodes, SAGE_BATCH, replace=False)
        return sample_blocks(g, seeds, SAGE_FANOUTS, rng)

    feats, blocks, labels, _ = sample()
    print(f"[sage] batch: feats {feats.shape}, blocks "
          f"{[b.shape for b in blocks]}", flush=True)
    batch = batch_to(feats, blocks, labels, device="cuda")
    with torch.no_grad():
        kern = phase_sage_kernel(sa, batch, cfg.hidden)

    # one forward and backward on the card against the same on the CPU
    model = GraphSAGE(cfg, device="cuda", seed=0)
    ref = GraphSAGE(cfg, device="cpu", seed=0)
    cpu_batch = batch_to(feats, blocks, labels, device="cpu")
    with torch.no_grad():
        d_logits = (model(batch["feats"], batch["blocks"]).cpu()
                    - ref(cpu_batch["feats"], cpu_batch["blocks"])).abs().max().item()
    loss_g, _ = sage_loss(model, batch)
    loss_g.backward()
    loss_c, _ = sage_loss(ref, cpu_batch)
    loss_c.backward()
    d_loss = abs(loss_g.item() - loss_c.item())
    d_grad = max((pg.grad.cpu() - pc.grad).abs().max().item()
                 for pg, pc in zip(model.parameters(), ref.parameters()))
    print(f"[sage] card vs cpu, batch 1: logits max diff {d_logits:.3g}, loss "
          f"{loss_g.item():.6f} vs {loss_c.item():.6f} (diff {d_loss:.3g}), "
          f"gradients max diff {d_grad:.3g} (atol {SAGE_ATOL})", flush=True)
    if not max(d_logits, d_loss, d_grad) <= SAGE_ATOL:
        raise AssertionError("GraphSAGE on the card disagrees with the CPU")
    model.zero_grad(set_to_none=True)

    # the main path: SGD steps, calibration, the DistDGL baseline plan
    sa.sage_aggregate.launches = 0
    wf.waterfill_fill.launches = 0
    losses, store_bytes, split = [], [], []
    for _ in range(SAGE_STEPS):
        t0 = time.perf_counter()
        feats, blocks, labels, per_store = sample()
        t1 = time.perf_counter()
        batch = batch_to(feats, blocks, labels, device="cuda")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        loss, m = sage_loss(model, batch)
        loss.backward()
        sgd_step(model, lr=0.1)
        losses.append(loss.item())  # a sync
        t3 = time.perf_counter()
        store_bytes.append(sum(per_store.values()))
        split.append((t1 - t0, t2 - t1, t3 - t2))
    vol_gb = float(np.mean(store_bytes)) / BYTES_PER_GB
    param_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    wl = build_gnn_workload(
        n_stores=4, n_workers=6, samplers_per_worker=2, n_ps=1, n_iters=40,
        store_to_sampler_gb=vol_gb, sampler_to_worker_gb=vol_gb,
        grad_gb=param_bytes / BYTES_PER_GB,
        store_exec_s=0.04, sampler_exec_s=0.08, worker_exec_s=0.15,
        ps_exec_s=0.015, pmr=float(np.max(store_bytes) / np.mean(store_bytes)),
    )
    dd = plan_baseline(wl, testbed_cluster(), baseline="distdgl",
                       realization=wl.realize(seed=0), device="cuda")
    torch.cuda.synchronize()
    launches = {"sage_aggregate": sa.sage_aggregate.launches,
                "waterfill_fill": wf.waterfill_fill.launches}
    print(f"[sage] losses over {SAGE_STEPS} SGD steps: "
          f"{' '.join(f'{v:.4f}' for v in losses)}", flush=True)
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"GraphSAGE training did not learn: {losses}")
    sp = np.array(split)
    print(f"[sage] step split (mean of {SAGE_STEPS}): sampling on the host "
          f"{sp[:, 0].mean():.4f} s, H2D copy {sp[:, 1].mean():.4f} s, forward "
          f"+ backward + SGD {sp[:, 2].mean():.4f} s; per step "
          f"{' / '.join(f'{a:.3f}+{b:.4f}+{c:.4f}' for a, b, c in sp)}",
          flush=True)
    print(f"[sage] calibrated: {vol_gb * BYTES_PER_GB / BYTES_PER_MIB:.1f} MiB per "
          f"batch, PMR {np.max(store_bytes) / np.mean(store_bytes):.3f}; DistDGL "
          f"baseline makespan {dd.schedule.makespan:.3f} s; launches on the path: "
          f"{launches}", flush=True)
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"the GraphSAGE path never launched {name}")

    # one profiled step: the device's busy share of a whole step
    def step():
        feats, blocks, labels, _ = sample()
        loss, _ = sage_loss(model, batch_to(feats, blocks, labels, device="cuda"))
        loss.backward()
        sgd_step(model, lr=0.1)
        torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        wall = time.perf_counter() - t0
    rows = sorted(
        (a for a in prof.key_averages() if a.device_type == DeviceType.CUDA),
        key=_device_us, reverse=True,
    )
    dev_ms = sum(_device_us(a) for a in rows) / 1e3
    print(f"[sage profile] one step: wall {wall:.3f} s profiled, device busy "
          f"{dev_ms:.2f} ms ({100 * dev_ms / 1e3 / wall:.2f}% of the wall)",
          flush=True)
    for a in rows[:8]:
        print(f"[sage profile]   {_device_us(a) / 1e3:9.3f} ms {a.count:5d}x "
              f"{a.key[:70]}", flush=True)
    return kern, launches


@contextlib.contextmanager
def _plain_attention():
    """The model's attention through the kernel's plain version, on the
    card (a check only: the port always calls the kernel)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import layers as ly

    saved = ly.flash_attention
    ly.flash_attention = fa.flash_attention_plain
    try:
        yield
    finally:
        ly.flash_attention = saved


def _flash_qkv(seed, B, H, KV, Sq, Sk, D, dtype):
    """Seeded q [B, H, Sq, D] and k, v [B, KV, Sk, D] on the card, as views
    of [B, S, N, D] tensors (the layout the model hands the kernel)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def draw(S, N):
        return torch.randn(B, S, N, D, generator=gen, device="cuda").to(dtype).transpose(1, 2)

    return draw(Sq, H), draw(Sk, KV), draw(Sk, KV)


def _flash_bound(B, H, KV, Sq, D, n_pairs, n_keys, elt):
    """Least time on the card: 4 D flops per unmasked (q, k) pair at the
    bf16 tensor-core peak, against q and o written or read once and the
    K and V positions the queries see read once, at the HBM rate."""
    flops = 4 * D * n_pairs
    n_bytes = elt * (2 * B * H * Sq * D + 2 * B * KV * n_keys * D)
    ops_ms = flops / BF16_FLOP_PER_S * 1e3
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes"), flops, n_bytes


def phase_flash_kernel(fa):
    """The attention kernel against its plain version at the sweep, prefill
    and decode shapes (fp32 and bf16), and its times at the prefill and
    decode shapes in bf16.  Returns the JSON numbers: the decode at the
    full cache (position 2047), the serving path's launch."""
    import torch
    import torch.nn.functional as F

    worst = 0.0
    checks = []
    for i, (b, h, sq, sk, d, causal, window, softcap) in enumerate(FLASH_SWEEP):
        checks.append((f"sweep {i}", (b, h, h, sq, sk, d), dict(
            causal=causal, window=window, softcap=softcap)))
    B, S = LM_PREFILL
    checks.append(("prefill", (B, 16, 8, S, S, 128), dict(causal=True)))
    for pos in DECODE_POSITIONS:
        checks.append((f"decode pos {pos}", (LM_SLOTS, 16, 8, 1, LM_SMAX, 128),
                       dict(causal=True, q_offset=pos)))
    for seed, (label, shape, kw) in enumerate(checks):
        errs = {}
        for dtype in ("float32", "bfloat16"):
            q, k, v = _flash_qkv(seed, *shape, getattr(torch, dtype))
            got = fa.flash_attention(q, k, v, **kw)
            want = fa.flash_attention_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            if not err <= FLASH_TOL[dtype]:
                raise AssertionError(f"flash kernel != plain at {label} {dtype}: "
                                     f"max err {err} (tol {FLASH_TOL[dtype]})")
            errs[dtype] = err
            worst = max(worst, err) if dtype == "float32" else worst
            del q, k, v, got, want
        print(f"[flash kernel] {label}: q {shape[:2] + shape[3:4] + shape[5:]} "
              f"over {shape[2]} KV heads x {shape[4]} keys, {kw}: max err fp32 "
              f"{errs['float32']:.3g}, bf16 {errs['bfloat16']:.3g}", flush=True)

    # times in bf16 (the model's dtype), L2 flushed before each call
    timed = [("prefill", (B, 16, 8, S, S, 128), dict(causal=True), None)]
    timed += [(f"decode pos {pos}", (LM_SLOTS, 16, 8, 1, LM_SMAX, 128),
               dict(causal=True, q_offset=pos), pos) for pos in DECODE_POSITIONS]
    rows = {}
    for label, (b, h, kv, sq, sk, d), kw, pos in timed:
        q, k, v = _flash_qkv(7, b, h, kv, sq, sk, d, torch.bfloat16)
        kernel = lambda: fa.flash_attention(q, k, v, **kw)
        plain = lambda: fa.flash_attention_plain(q, k, v, **kw)
        if pos is None:
            lib = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                         enable_gqa=True)
        else:  # the one query row sees keys 0..pos
            kk, vv = k[:, :, : pos + 1], v[:, :, : pos + 1]
            lib = lambda: F.scaled_dot_product_attention(q, kk, vv, enable_gqa=True)
        err_lib = (lib().float() - plain().float()).abs().max().item()
        ms = _device_ms(kernel, 10 if pos is None else 50, flush=True)
        plain_ms = _device_ms(plain, 2 if pos is None else 10, flush=True)
        library_ms = _device_ms(lib, 10 if pos is None else 50, flush=True)
        mask = fa.causal_mask(sq, sk, kw.get("window"), kw.get("q_offset", 0),
                              kw["causal"], device="cuda")
        n_pairs = b * h * int(mask.sum().item())
        n_keys = int(mask.any(0).sum().item())
        bound, by, flops, n_bytes = _flash_bound(b, h, kv, sq, d, n_pairs, n_keys, 2)
        print(
            f"[flash kernel] {label} bf16: device time per call, L2 flushed: "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"scaled_dot_product_attention {library_ms:.4f} ms (max diff to "
            f"plain {err_lib:.3g}); bound {bound:.6f} ms by {by} ({flops} "
            f"flops, {n_bytes} bytes; {100 * bound / ms:.1f}% of the kernel's "
            f"time)", flush=True)
        rows[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                           bound_ms=bound, bound_by=by)
        del q, k, v
    out = dict(rows[f"decode pos {DECODE_POSITIONS[-1]}"])
    out["max_abs_err"] = worst
    return out


def phase_lm(fa):
    """internlm2-1.8b on the card: prefill through the kernel against the
    plain attention, fp32 card against CPU at 2 layers, decode against
    forward, then the main path (ServeEngine, counts set to 0 just before
    and read just after) and one profiled tick.  Returns the path's
    flash launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import TransformerLM
    from repro_torch.serve import Request, ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    model = TransformerLM(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[lm] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads over {cfg.n_kv_heads} KV heads, head_dim "
          f"{cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab} padded to {model.vp}; "
          f"{n_params} parameters in {cfg.dtype} (param_count {cfg.param_count()}), "
          f"initialised on the card in {time.perf_counter() - t0:.1f} s", flush=True)

    # prefill of 4 x 2048 tokens: the kernel against the plain attention
    B, S = LM_PREFILL
    gen = torch.Generator(device="cuda").manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (B, S), generator=gen, device="cuda")
    before = fa.flash_attention.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = model.prefill(toks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_launch = fa.flash_attention.launches - before
    with _plain_attention():
        want = model.prefill(toks)
    if not (torch.isfinite(got[:, : cfg.vocab]).all() and got.shape == (B, model.vp)):
        raise AssertionError("prefill logits not finite or of the wrong shape")
    if n_launch != cfg.n_layers:
        raise AssertionError(f"prefill launched the kernel {n_launch} times")
    d_pre = (got - want)[:, : cfg.vocab].abs().max().item()
    agree = int((got.argmax(-1) == want.argmax(-1)).sum().item())
    print(f"[lm] prefill {B} x {S} tokens, bf16: {wall:.3f} s (first call), "
          f"{n_launch} kernel launches; against the plain attention: max abs "
          f"logit diff {d_pre:.4g} (logits in [{got[:, :cfg.vocab].min().item():.3f}, "
          f"{got[:, :cfg.vocab].max().item():.3f}]), argmax agrees on {agree} of "
          f"{B}", flush=True)

    # 2 layers at full width in fp32: the card's kernel path against the
    # CPU's plain path, and decode against forward on the card
    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    cpu_m = TransformerLM(cfg2, device="cpu").init(torch.Generator().manual_seed(2))
    card_m = TransformerLM(cfg2, device="cuda")
    card_m.load_state_dict(cpu_m.state_dict())
    toks2 = torch.randint(0, cfg.vocab, (2, 256), generator=torch.Generator().manual_seed(3))
    h_card = card_m.forward(toks2.cuda()).cpu()
    h_cpu = cpu_m.forward(toks2)
    l_card, l_cpu = card_m.prefill(toks2.cuda()).cpu(), cpu_m.prefill(toks2)
    d_h = (h_card - h_cpu).abs().max().item()
    d_l = (l_card - l_cpu)[:, : cfg.vocab].abs().max().item()
    print(f"[lm] 2 layers, full width, fp32, 2 x 256 tokens: card (kernel) vs "
          f"cpu (plain): hidden max diff {d_h:.3g}, last logits max diff "
          f"{d_l:.3g} (atol {LM_FP32_ATOL})", flush=True)
    if not max(d_h, d_l) <= LM_FP32_ATOL:
        raise AssertionError("the card's fp32 LM disagrees with the CPU's")
    del cpu_m

    def decode_vs_forward(m, n_pos, batch):
        tk = torch.randint(0, cfg.vocab, (batch, n_pos),
                           generator=torch.Generator().manual_seed(4)).cuda()
        full = m._logits(m.forward(tk))[..., : cfg.vocab]
        cache = m.cache_struct(batch, n_pos)
        errs, agree = [], 0
        for t in range(n_pos):
            cache, lg = m.decode_step(cache, tk[:, t], t)
            lg = lg[:, : cfg.vocab]
            errs.append((lg - full[:, t]).abs().max().item())
            agree += int((lg.argmax(-1) == full[:, t].argmax(-1)).all().item())
        return errs, agree

    errs, agree = decode_vs_forward(card_m, 16, 2)
    print(f"[lm] decode vs forward, 2 layers fp32 on the card, 16 positions: "
          f"max err per position {' '.join(f'{e:.2g}' for e in errs)}; argmax "
          f"agrees at {agree} of 16", flush=True)
    if not (errs[0] < 1e-3 and max(errs) < 1e-2 and agree == 16):
        raise AssertionError("fp32 decode disagrees with the forward")
    del card_m
    errs, agree = decode_vs_forward(model, 16, LM_SLOTS)
    print(f"[lm] decode vs forward, {cfg.n_layers} layers bf16, {LM_SLOTS} "
          f"sequences, 16 positions: max err per position "
          f"{' '.join(f'{e:.2g}' for e in errs)}; argmax agrees on all "
          f"sequences at {agree} of 16 positions", flush=True)
    if not all(np.isfinite(errs)):
        raise AssertionError("bf16 decode or forward not finite")

    # the main path: ServeEngine at launch/serve.py's defaults, smax 2048
    # and 128 new tokens each
    def requests(n, max_tokens):
        return [Request(rid=i, prompt=[1 + i % 13, 2, 3], max_tokens=max_tokens)
                for i in range(n)]

    engine = ServeEngine(model, n_slots=LM_SLOTS, smax=LM_SMAX)
    reqs = requests(LM_REQUESTS, LM_MAX_TOKENS)
    for r in reqs:
        engine.submit(r)
    torch.cuda.synchronize()
    fa.flash_attention.launches = 0
    stats = engine.run()
    launches = fa.flash_attention.launches
    ms_tick = 1e3 * stats["wall_s"] / stats["ticks"]
    print(f"[lm serve] {LM_REQUESTS} requests, {LM_SLOTS} slots, smax {LM_SMAX}, "
          f"{LM_MAX_TOKENS} new tokens each: {stats['tokens']} tokens over "
          f"{stats['ticks']} ticks in {stats['wall_s']:.3f} s: "
          f"{stats['tok_per_s']:.1f} tokens/s, {ms_tick:.3f} ms per tick; "
          f"flash launches {launches} ({launches / stats['ticks']:.1f} per tick)",
          flush=True)
    if launches == 0:
        raise AssertionError("the serving path never launched flash_attention")
    if launches != cfg.n_layers * stats["ticks"]:
        raise AssertionError(f"expected {cfg.n_layers} launches per tick")
    if not all(r.done for r in reqs) or stats["tokens"] != LM_REQUESTS * (LM_MAX_TOKENS + 1):
        raise AssertionError("the engine did not finish every request")
    if not all(0 <= t < cfg.vocab for r in reqs for t in r.out):
        raise AssertionError("the engine emitted a token outside the vocabulary")
    # the first wave (admitted at position 0, on a clean cache) against a
    # teacher-forced forward of the same sequences
    first = reqs[:LM_SLOTS]
    seqs = torch.tensor([r.prompt[:1] + r.out for r in first], device="cuda")
    with torch.no_grad():
        pred = model._logits(model.forward(seqs[:, :-1]))[..., : cfg.vocab].argmax(-1)
    gen_from = len(first[0].prompt) - 1  # positions whose next token was generated
    tf_agree = (pred[:, gen_from:] == seqs[:, gen_from + 1:]).float().mean().item()
    print(f"[lm serve] first wave's {seqs.shape[1] - 1 - gen_from} generated "
          f"tokens per request against a teacher-forced bf16 forward: "
          f"{100 * tf_agree:.1f}% agree", flush=True)

    # one profiled tick (8 busy slots, past the prompt feed)
    engine = ServeEngine(model, n_slots=LM_SLOTS, smax=LM_SMAX)
    for r in requests(LM_SLOTS, 16):
        engine.submit(r)
    for _ in range(4):
        engine.tick()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.tick()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = sorted(
        (a for a in prof.key_averages() if a.device_type == DeviceType.CUDA),
        key=_device_us, reverse=True,
    )
    dev_ms = sum(_device_us(a) for a in rows) / 1e3
    n_kernels = sum(a.count for a in rows)
    print(f"[lm profile] one tick at position {engine.pos - 1}: wall {1e3 * wall:.3f} "
          f"ms profiled, device busy {dev_ms:.3f} ms ({100 * dev_ms / 1e3 / wall:.1f}% "
          f"of the profiled wall, {100 * dev_ms / ms_tick:.1f}% of the engine run's "
          f"mean tick), {n_kernels} device operations", flush=True)
    # the tick's device time split: the attention kernel, the matrix
    # products (cuBLAS), and the rest (copies, casts, norms, RoPE, adds)
    split = {"flash_attention": 0.0, "matmul": 0.0, "other": 0.0}
    for a in rows:
        key = a.key.lower()
        part = ("flash_attention" if "flash_decode" in key or "flash_tiled" in key
                else "matmul" if any(w in key for w in ("gemm", "nvjet", "gemv"))
                else "other")
        split[part] += _device_us(a) / 1e3
    print("[lm profile] device time split: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in split.items()), flush=True)
    for a in rows[:10]:
        print(f"[lm profile]   {_device_us(a) / 1e3:9.3f} ms {a.count:5d}x "
              f"{a.key[:70]}", flush=True)
    return launches


def _phase_done(name, t0):
    print(f"[time] {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return time.perf_counter()


def _flash_entry(flash, launches):
    return {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:102",
        "launches": launches,
        "max_abs_err": flash["max_abs_err"],
        "ms": flash["ms"],
        "plain_ms": flash["plain_ms"],
        "bound_ms": flash["bound_ms"],
        "bound_by": flash["bound_by"],
        "library_ms": flash["library_ms"],
    }


def phase_lm_serve(fa, t):
    """Phase 7: the attention kernel's checks and times, then the LM."""
    flash = phase_flash_kernel(fa)
    t = _phase_done("flash_attention kernel checks and times", t)
    launches = phase_lm(fa)
    t = _phase_done("LM serving (internlm2-1.8b: prefill, parity, decode, "
                    "ServeEngine, profile)", t)
    return flash, launches, t


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=("lm_serve",), default=None,
                    help="build the kernels and run this phase alone")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import sage_aggregate as sa
    from repro_torch.kernels import waterfill as wf

    t_start = t = time.perf_counter()
    print(f"[device] {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    sources = (wf.SOURCE, sa.SOURCE, fa.SOURCE)
    for src, (_, secs, log) in zip(sources, _build.build(*sources)):
        print(f"[build] {src.name} built in {secs:.1f} s", flush=True)
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[build] {line.strip()}", flush=True)
    t = _phase_done("build (three kernels, in parallel)", t)
    if args.only == "lm_serve":
        flash, flash_launches, t = phase_lm_serve(fa, t)
        print(json.dumps({"kernels": [_flash_entry(flash, flash_launches)]}))
        print(f"[done] {time.perf_counter() - t_start:.1f} s (lm_serve only)")
        return 0

    kern = phase_kernel(wf)
    t = _phase_done("waterfill kernel checks", t)

    # the planning path: counts set to 0 here, read after the plan phase
    wf.waterfill_fill.launches = 0
    sa.sage_aggregate.launches = 0
    with ProcessPoolExecutor(CPU_WORKERS, mp_context=get_context("spawn")) as pool:
        cands, pending, gpu = phase_engine(wf, pool)
        t = _phase_done("engine at width 1024", t)
        phase_plan(wf)
        launches = wf.waterfill_fill.launches
        t = _phase_done("plan() and the DistDGL baseline", t)
        check_engine(pending, gpu)
        t = _phase_done("waiting for the CPU references", t)
    if launches == 0:
        raise AssertionError("the main path never launched the waterfill kernel")
    phase_profile(cands)
    t = _phase_done("engine profile", t)

    sage, sage_launches = phase_sage(sa, wf)
    t = _phase_done("GraphSAGE (graph, kernel checks, parity, training, "
                    "calibration, profile)", t)

    flash, flash_launches, t = phase_lm_serve(fa, t)

    line = {
        "kernels": [
            {
                "name": "waterfill_fill",
                "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/waterfill.cu",
                "replaces": "src/repro/kernels/waterfill.py:64",
                "launches": launches + sage_launches["waterfill_fill"],
                "max_abs_err": kern["max_abs_err"],
                "ms": kern["ms"],
                "plain_ms": kern["plain_ms"],
                "bound_ms": kern["bound_ms"],
                "bound_by": kern["bound_by"],
                "library_ms": None,
            },
            {
                "name": "sage_aggregate",
                "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/sage_aggregate.cu",
                "replaces": "src/repro/kernels/sage_aggregate.py:83",
                "launches": sage_launches["sage_aggregate"],
                "max_abs_err": sage["max_abs_err"],
                "ms": sage["ms"],
                "plain_ms": sage["plain_ms"],
                "bound_ms": sage["bound_ms"],
                "bound_by": sage["bound_by"],
                "library_ms": sage["library_ms"],
            },
            _flash_entry(flash, flash_launches),
        ]
    }
    print(f"[launches] planning path: waterfill_fill {launches}; GraphSAGE "
          f"path: {sage_launches}; serving path: flash_attention "
          f"{flash_launches}", flush=True)
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps(line))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
