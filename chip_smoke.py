#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py        # on a machine with one CUDA card

Drives the port's paths on the card, DGTP planning, GraphSAGE training
and LM serving (dense, mamba2 and MoE), and holds them against the
port's own CPU path and against the plain version of every kernel.
Phases, in order; any failure ends the run with a non-zero exit:

  1. build the five kernels (waterfill, sage_aggregate, flash_attention,
     ssd_scan, moe_gemm) from ``src/repro_torch/kernels/csrc`` with nvcc
     for sm_90a, one nvcc per source, all started together; TF32 off for
     fp32 products and convolutions;
  2. the waterfill kernel against its plain version on the card, at
     every shape the main path gives it (B=1024 with EG=1400, M=16 and
     with EG=72, M=4; B=1 with EG=72, M=4), on inputs with tied priority
     keys: exact equality, and device times; the chain probe at each
     shape (the kernel's dependent chain alone: its chain bound) and, at
     the papers shape, the plain shared-memory step and the
     one-NIC-a-lane shuffle form beside it;
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
     fp32, 3e-2 in bf16, plus all-padding rows and an odd M), and its
     backward kernels against the plain backward on the CPU (exact in
     fp32), both giving the same bits on two runs; the forward's times
     beside its bound, the gather probe (its loads alone) and
     ``F.embedding_bag``, the backward's beside its bound and
     ``index_add_``, also on ids with three hubs named thousands of
     times; one forward and backward on the card against the same on
     the CPU; then five SGD steps, the measured-traffic calibration and
     ``plan_baseline("distdgl")`` (its fifo commit launches waterfill);
     then one profiled step, checked to hold every aggregation launch
     (the device's busy share; no ``index_add_`` left);
  7. LM serving (internlm2-1.8b, bf16, random weights from a seeded
     generator on the card): the attention kernel against its plain
     version at the five sweep shapes of ``tests/test_kernels.py``, at
     head dims 80 and 112 on every route (prefill, decode over several
     chunks, a window, a softcap, a row with no valid key), the prefill
     shape q [4, 16, 2048, 128] over 8 KV heads and the decode shape q
     [8, 16, 1, 128] against a [8, 2048, 8, 128] cache at three positions
     (fp32 within 2e-5, bf16 within 2e-2), with times beside its bound and
     ``F.scaled_dot_product_attention``, also at kimi-k2's decode shape q
     [8, 64, 1, 112], each timed decode giving the same bits on two runs;
     ``prefill`` of
     4 x 2048 tokens through the kernel (its 24 launches all on the wgmma
     route; the wall of a first and of a second, warm call) against the
     same with the plain attention; 2 layers at full width in fp32 on the
     card against the CPU, and decode against forward; decode against
     forward at full depth in bf16; then ``ServeEngine`` (16 requests, 8
     slots, smax 2048, 128 new tokens each) and one profiled tick;
  8. mamba_serve (mamba2-1.3b, bf16, full width and depth, random
     weights): the SSD scan kernel against its plain version at the
     sweep shapes of ``tests/test_kernels.py``, the smoke config's chunk
     of 32 and the prefill shape x [4, 2048, 64, 64] with d_state 128 and
     chunk 256, also as views of one projection (fp32 within 1e-4, bf16
     within 2e-2 of the output's largest magnitude; bf16 on the mma
     route, fp32 on the FMA route), times at the prefill shape on both
     routes and the mma route's share of its bound, the mma route giving
     the same bits on two runs; 2 layers at full width in fp32 on the
     card against the CPU, and decode against forward; then the prefill
     of 4 x 2048 tokens (its 48 launches all on the mma route) and
     ``ServeEngine`` at phase 7's traffic, the prefill against the plain
     scan and timed again warm, and one profiled tick;
  9. moe_serve (llama4-scout-17b-a16e, bf16, full width, 8 of its 48
     layers): the grouped GEMM kernel against its plain version at the
     sweep shapes (an empty expert, rows past the sum) and the decode
     (T = 8) and prefill (T = 8192) shapes, and kimi-k2's decode (T = 64
     over 384 experts), times beside the bound and ``torch._grouped_mm``,
     each timed decode giving the same bits on two runs; 2 layers in fp32,
     kernels against plain versions on the card, and decode against
     forward; then the prefill (its 24 moe_gemm and 8 flash launches all
     on the wgmma routes) and ``ServeEngine`` as in phase 8, and one
     profiled tick;
 10. kimi_serve (kimi-k2-1t-a32b, bf16, full width: d_model 7168, 64
     heads of 112 over 8 KV heads, 384 experts top-8; 1 of its 61 layers,
     as one layer's experts are 33.8 GB): the attention kernel at its
     prefill and decode shapes; the prefill (on the wgmma routes) and
     ``ServeEngine`` as in phase 8, the ticks on flash's decode and
     moe_gemm's streaming routes; the prefill against the plain path;
     decode against forward beside the same through the plain versions;
     one profiled tick;
 11. the kernel table's JSON line (the flash and moe_gemm records also
     carry their prefill shape's times, ``prefill_ms``,
     ``prefill_bound_ms``, ``prefill_library_ms``, and kimi-k2's decode
     shape's, ``kimi_decode_ms``, ``kimi_decode_plain_ms``,
     ``kimi_decode_bound_ms``, ``kimi_decode_library_ms``; waterfill's
     its measured ``chain_bound_ms`` beside the bytes bound; ssd_scan's
     its path's ``launches_by_route`` and the FMA route's
     ``fma_ms``; sage_aggregate's the gather probe's ``probe_ms`` and
     its backward's ``bwd_ms``,
     ``bwd_bound_ms`` and ``bwd_library_ms``), the card's name and power
     limit, and the closing status line.

Six main paths, each with the kernel launch counts set to 0 just
before it and read just after: phases 3-4 (planning), the training
steps, calibration and baseline plan of phase 6 (GraphSAGE), the
``ServeEngine`` run of phase 7 (LM serving), and the prefill followed by
the ``ServeEngine`` run of phases 8 (mamba2), 9 (MoE) and 10 (kimi-k2).
Each phase's seconds are printed on a ``[time]`` line.  ``--only
sage``, ``lm_serve``, ``mamba_serve``, ``moe_serve`` or ``kimi_serve``
builds the kernels and runs that phase alone (for work on that path; it prints no
closing status line).
Imports nothing of JAX or of the ``repro`` package.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import re
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
# mamba_serve: mamba2-1.3b at full width and depth, at phase 7's traffic;
# the scan's sweep shapes of tests/test_kernels.py (b, s, h, hd, ds, chunk)
MAMBA_ARCH = "mamba2-1.3b"
SSD_SWEEP = [(2, 128, 4, 32, 16, 32), (1, 256, 2, 64, 64, 64)]
# moe_serve: llama4-scout at full width and 8 of its 48 layers (its 16
# experts are 4.03 GB a layer in bf16: 48 layers do not fit one card);
# the grouped GEMM's sweep shapes of tests/test_kernels.py (t, d, f, e)
MOE_ARCH = "llama4-scout-17b-a16e"
MOE_LAYERS = 8
MOE_SWEEP = [(256, 128, 128, 4), (512, 256, 256, 8)]
# kimi_serve: kimi-k2-1t-a32b at full width and 1 of its 61 layers (its
# 384 experts are 33.8 GB a layer in bf16: two layers do not fit one card)
KIMI_ARCH = "kimi-k2-1t-a32b"
KIMI_LAYERS = 1
# decode logits against the forward's at the same positions, in bf16: at
# each position within 1e-2, or within 1.5x the same comparison through
# the plain versions there, whichever is larger.  bf16 products of other
# shapes (the forward's 128 rows against a decode step's 8) round
# differently, and at 7168 wide that alone moves a logit by 1-3e-2 (the
# plain path: 0.013-0.026, and 0.76-0.84 where a top-8 near-tie routes a
# token to another expert; the kernels: 0.014-0.030; NVIDIA H100 80GB HBM3
# at 700 W): the kernels must add no more than the plain path's rounding
KIMI_DECODE_ATOL = 1e-2
KIMI_DECODE_NOISE = 1.5
# the attention checks at head dims 80 and 112 on every route: (label, (B,
# H, KV, Sq, Sk, D), kwargs); prefill (fma in fp32, wgmma in bf16) and
# decode, a window, a softcap, an offset, rows with no valid key, chunks
FLASH_HEAD_DIM_CHECKS = [
    ("hd80 prefill", (2, 4, 2, 300, 300, 80), dict(causal=True, softcap=30.0)),
    ("hd112 prefill", (1, 8, 1, 333, 400, 112), dict(causal=True, window=100, q_offset=67)),
    ("hd80 decode", (3, 10, 2, 1, 900, 80), dict(causal=True, q_offset=850)),
    ("hd112 decode", (2, 16, 2, 1, 1500, 112), dict(causal=True, window=700, q_offset=1400)),
    ("hd112 decode, no valid key", (1, 8, 1, 1, 600, 112), dict(causal=True, window=4,
                                                               q_offset=700)),
]
# the new kernels against their plain versions, relative to the output's
# largest magnitude: fp32 differs only in the order of sums; bf16 rounds
# the output once (the plain versions round the same fp32 sums)
KERNEL_RTOL = {"float32": 1e-4, "bfloat16": 2e-2}
# a bf16 prefill through the kernels against the same prefill through the
# plain versions, relative to the largest plain logit: only the rounding
# differs, and it compounds over the layers (2.3% at internlm2-1.8b's 24
# layers, 5.1% at mamba2-1.3b's 48, 5.8% at llama4-scout's 8, on an NVIDIA
# H100 80GB HBM3 at 700 W); a wrong kernel moves logits by their own size
PREFILL_RTOL = 0.1
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
        # device time (the host's issue time left out: at the products
        # shape it is longer than the kernel's), L2 not flushed: in the
        # engine the inputs come straight from the argsort and the masks
        ms = _device_ms(lambda: wf.waterfill_fill(*args), 50)
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
        # the chain bound: the longest chain of these inputs (an
        # instance's eligible flows, the steps the kernel walks) alone, on
        # chip
        n_chain = int(args[3].sum(1).max().item())
        chain_ms, cycles = wf.chain_probe(n_chain, M)
        print(
            f"[kernel] waterfill chain probe EG={EG} M={M}: chain bound "
            f"{chain_ms:.6f} ms for the longest chain ({n_chain} eligible "
            f"steps; {cycles:.1f} cycles a step), {100 * chain_ms / ms:.1f}% "
            f"of the kernel's time",
            flush=True,
        )
        if not 0 < chain_ms < ms:
            raise AssertionError(f"waterfill at {label}: chain bound {chain_ms} ms "
                                 f"not in (0, kernel's {ms} ms)")
        if not rows:  # the papers shape: the other forms of the step
            for mode in ("kernel", "shared", "shuffle"):
                m_ms, m_cycles = wf.chain_probe(EG, M, mode=mode)
                print(f"[kernel] waterfill chain probe, {EG} steps, M={M}, {mode} "
                      f"form: {m_ms:.6f} ms ({m_cycles:.1f} cycles a step)", flush=True)
        rows.append(dict(
            ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            max_abs_err=float((got - want).abs().max().item()),
            chain_bound_ms=chain_ms,
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


SAGE_HUBS = 3  # ids each named by a third of layer 1's output rows


def _sage_hubs(sa, batch, hidden, gen):
    """The backward on layer 1's ids with the first id of every row
    replaced by one of SAGE_HUBS hubs (each named ~2239 times, as a
    power-law graph's hubs are): exact against the plain backward on the
    CPU, timed beside ``index_add_`` with the L2 flushed."""
    import torch

    _, x, idx = _sage_x(batch["feats"], batch["blocks"], hidden, 0)[1]
    N, Fdim = x.shape
    M, K = idx.shape
    idx = idx.clone()
    idx[:, 0] = torch.arange(M, device="cuda", dtype=torch.int32) % SAGE_HUBS
    go = torch.randn(M, Fdim, device="cuda", generator=gen)
    backward = lambda: sa.sage_aggregate_backward(go, idx, N)
    if not torch.equal(backward().cpu(),
                       sa.sage_aggregate_backward_plain(go.cpu(), idx.cpu(), N)):
        raise AssertionError("sage backward != plain on the cpu with hubs")
    flat = idx.reshape(-1).long()
    pos = torch.nonzero(flat >= 0).squeeze(1)
    cnt = (idx >= 0).sum(1).clamp(min=1)[:, None].float()
    add_ids, add_rows = flat[pos], (go / cnt)[pos // K]
    add_buf = torch.zeros(N, Fdim, device="cuda")
    ms = _device_ms(backward, 20, flush=True)
    lib_ms = _device_ms(lambda: add_buf.index_add_(0, add_ids, add_rows), 20, flush=True)
    longest = int((idx == 0).sum().item())
    print(f"[sage backward] layer 1 with {SAGE_HUBS} hubs (the longest segment "
          f"{longest} positions): exact match with the plain backward on the cpu; "
          f"device time per call, L2 flushed: kernels {ms:.4f} ms, index_add_ "
          f"{lib_ms:.4f} ms", flush=True)
    return {"bwd_hub_ms": ms, "bwd_hub_library_ms": lib_ms}


def phase_sage_kernel(sa, batch, hidden):
    """The aggregation kernels against their plain versions at the three
    shapes one batch gives them: the forward exact in fp32 and within
    BF16_ATOL in bf16, the backward exact in fp32
    against the plain backward on the CPU, each giving the same bits on
    two runs; all-padding rows and an M that is not a multiple of 128;
    the forward's times beside its bound, the gather probe (its loads
    alone) and ``F.embedding_bag``; the backward's beside its bound and
    ``index_add_``, at each shape and on layer 1's ids with three hubs
    named thousands of times.  Returns the JSON numbers: the forward's summed over
    the three shapes (one forward's aggregations), the backward's over
    layers 1 and 2 (one backward's: layer 0's input needs no gradient)."""
    import torch
    import torch.nn.functional as F

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(1)
    for label, x, idx in _sage_x(batch["feats"], batch["blocks"], hidden, 0):
        N, Fdim = x.shape
        M, K = idx.shape
        got = sa.sage_aggregate(x, idx)
        want = sa.sage_aggregate_plain(x, idx)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            err = (got - want).abs().max().item()
            raise AssertionError(f"sage kernel != plain at {label} (max {err})")
        _bit_stable(f"sage forward {label}", lambda: sa.sage_aggregate(x, idx))
        xb = x.to(torch.bfloat16)
        err_bf16 = (sa.sage_aggregate(xb, idx).float()
                    - sa.sage_aggregate_plain(xb, idx).float()).abs().max().item()
        if not err_bf16 <= BF16_ATOL:
            raise AssertionError(f"sage kernel bf16 at {label}: max err {err_bf16}")
        bf16_vec = sa.forward_plan(Fdim, 2, xb.data_ptr()).vec_bytes
        # the backward: kernels against the plain backward on the CPU
        go = torch.randn(M, Fdim, device="cuda", generator=gen)
        backward = lambda: sa.sage_aggregate_backward(go, idx, N)
        g_got = backward()
        g_want = sa.sage_aggregate_backward_plain(go.cpu(), idx.cpu(), N)
        if not torch.equal(g_got.cpu(), g_want):
            err = (g_got.cpu() - g_want).abs().max().item()
            raise AssertionError(f"sage backward != plain on the cpu at {label} (max {err})")
        _bit_stable(f"sage backward {label}", backward)
        # the yardsticks: one PyTorch call with the same semantics each
        bag_idx = torch.where(idx < 0, N, idx).long()
        bag_x = torch.cat([x, x.new_zeros(1, Fdim)])
        lib = lambda: F.embedding_bag(bag_idx, bag_x, mode="mean", padding_idx=N)
        err_lib = (lib() - want).abs().max().item()
        flat = idx.reshape(-1).long()
        pos = torch.nonzero(flat >= 0).squeeze(1)
        cnt = (idx >= 0).sum(1).clamp(min=1)[:, None].float()
        add_ids, add_rows = flat[pos], (go / cnt)[pos // K]
        add_buf = torch.zeros(N, Fdim, device="cuda")
        bwd_lib = lambda: add_buf.index_add_(0, add_ids, add_rows)
        kernel = lambda: sa.sage_aggregate(x, idx)
        plain = lambda: sa.sage_aggregate_plain(x, idx)
        # device time per call with the 50 MB L2 flushed before each call
        # (x is 7-37 MB, so back-to-back calls find it in L2 and beat the
        # memory bound); the hot kernel time is printed beside it
        ms = _device_ms(kernel, 20, flush=True)
        hot_ms = _device_ms(kernel, 50)
        probe_ms = _device_ms(lambda: sa.gather_probe(x, idx), 20, flush=True)
        probe_hot_ms = _device_ms(lambda: sa.gather_probe(x, idx), 50)
        plain_ms = _device_ms(plain, 4, flush=True)
        library_ms = _device_ms(lib, 20, flush=True)
        bwd_ms = _device_ms(backward, 20, flush=True)
        bwd_library_ms = _device_ms(bwd_lib, 20, flush=True)
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
        # the backward's: grad_out, idx, the CSR (N row ends, a position per
        # valid id) and grad_x once each; a divide per grad_out value and
        # an add per gathered value
        bwd_bytes = M * Fdim * 4 + M * K * 4 + (N + n_valid) * 4 + N * Fdim * 4
        bwd_bound = max(bwd_bytes / HBM_BYTES_PER_S,
                        (M * Fdim + n_valid * Fdim) / FP32_FLOP_PER_S) * 1e3
        print(
            f"[sage kernel] {label}: x {tuple(x.shape)} fp32, idx {tuple(idx.shape)} "
            f"({n_valid} valid ids, {n_rows} distinct rows): exact match, bf16 max err "
            f"{err_bf16:.3g} ({bf16_vec}-byte accesses); device time per call, "
            f"L2 flushed: kernel {ms:.4f} ms (hot {hot_ms:.4f} ms), gather probe "
            f"{probe_ms:.4f} ms (hot {probe_hot_ms:.4f} ms), plain {plain_ms:.4f} ms, embedding_bag "
            f"{library_ms:.4f} ms (max diff {err_lib:.3g}); bound {bound:.6f} ms "
            f"({n_bytes} bytes, {100 * bound / ms:.1f}% of the kernel's time); "
            f"back-to-back calls, host included: kernel {call_ms:.4f} ms, "
            f"embedding_bag {lib_call_ms:.4f} ms",
            flush=True,
        )
        print(
            f"[sage backward] {label}: grad_out {tuple(go.shape)} fp32 -> grad_x "
            f"{tuple(g_got.shape)}: exact match with the plain backward on the cpu; "
            f"device time per call, L2 flushed: kernels {bwd_ms:.4f} ms, index_add_ "
            f"{bwd_library_ms:.4f} ms; bound {bwd_bound:.6f} ms ({bwd_bytes} bytes, "
            f"{100 * bwd_bound / bwd_ms:.1f}% of the kernels' time)",
            flush=True,
        )
        rows.append(dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=bound, bytes_ms=bytes_ms, ops_ms=ops_ms,
                         probe_ms=probe_ms,
                         bwd_ms=bwd_ms, bwd_bound_ms=bwd_bound,
                         bwd_library_ms=bwd_library_ms,
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
                                                  "bound_ms", "bytes_ms", "ops_ms",
                                                  "probe_ms")}
    out.update({k: sum(r[k] for r in rows[1:])
                for k in ("bwd_ms", "bwd_bound_ms", "bwd_library_ms")})
    out["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    out["bound_by"] = "bytes" if out["bytes_ms"] >= out["ops_ms"] else "operations"
    out.update(_sage_hubs(sa, batch, hidden, gen))
    print(f"[sage kernel] one forward (three calls), L2 flushed: kernel {out['ms']:.4f} "
          f"ms against a bound of {out['bound_ms']:.6f} ms and a gather probe of "
          f"{out['probe_ms']:.4f} ms (embedding_bag {out['library_ms']:.4f} ms); one "
          f"backward (layers 1 and 2): kernels {out['bwd_ms']:.4f} ms against a bound of "
          f"{out['bwd_bound_ms']:.6f} ms, index_add_ {out['bwd_library_ms']:.4f} ms",
          flush=True)
    return out


def phase_sage(sa, wf):
    """GraphSAGE on the card: the kernel checks, card-vs-CPU parity, then
    the main path (training steps, calibration, DistDGL baseline plan)
    with the launch counts set to 0 just before and read just after, then
    one profiled step.  Returns the kernel numbers and the path's
    launches per kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

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
    sa.sage_aggregate.backward_launches = 0
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
                "sage_aggregate_backward": sa.sage_aggregate.backward_launches,
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

    # the profiler can lose the first device events it traces, so a step
    # runs as its warm-up and the next one is kept; the kept step must
    # hold every launch of the aggregation and the batch's copies to the
    # card, or it is traced again
    expect = {"sage_fwd": 3, "sage_bwd_prep": 2, "sage_bwd_fill": 2, "sage_bwd_long": 2,
              "sage_bwd_sum": 2}
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1), acc_events=True) as prof:
            for _ in range(2):
                t0 = time.perf_counter()
                step()
                wall = time.perf_counter() - t0
                prof.step()
        # the schedule's step annotation carries its kernels' time again
        rows = sorted(
            (a for a in prof.key_averages() if a.device_type == DeviceType.CUDA
             and not a.key.startswith("ProfilerStep")),
            key=_device_us, reverse=True,
        )
        seen = {k: sum(a.count for a in rows if re.search(rf"::{k}[<(]", a.key))
                for k in expect}
        copies = sum(a.count for a in rows if a.key.startswith("Memcpy HtoD"))
        if seen == expect and copies > 0:
            break
        print(f"[sage profile] trace {attempt + 1} incomplete: aggregation launches "
              f"{seen} of {expect}, {copies} host-to-device copies", flush=True)
    else:
        raise AssertionError("the profiled GraphSAGE step lost device events")
    dev_ms = sum(_device_us(a) for a in rows) / 1e3
    kernel_ms = sum(_device_us(a) for a in rows if not a.key.startswith("Memcpy")) / 1e3
    print(f"[sage profile] one step: wall {wall:.3f} s profiled, device busy "
          f"{dev_ms:.3f} ms ({100 * dev_ms / 1e3 / wall:.2f}% of the wall), of which "
          f"kernels (no host-to-device copies) {kernel_ms:.3f} ms; every aggregation "
          f"launch traced {seen}, {copies} host-to-device copies", flush=True)
    for a in rows[:8]:
        print(f"[sage profile]   {_device_us(a) / 1e3:9.3f} ms {a.count:5d}x "
              f"{a.key[:70]}", flush=True)
    ours = [a for a in rows if "sage_" in a.key]
    print(f"[sage profile] the aggregation's kernels: "
          f"{sum(_device_us(a) for a in ours) / 1e3:.3f} ms ("
          + ", ".join(f"{re.search(r'sage_\w+(<[^>]*>)?', a.key).group(0)} "
                      f"{_device_us(a) / 1e3:.3f} ms {a.count}x" for a in ours) + ")",
          flush=True)
    scatter = [a.key for a in rows if "indexFunc" in a.key]
    if scatter:
        raise AssertionError(f"the GraphSAGE step still runs index_add_: {scatter}")
    return kern, launches


@contextlib.contextmanager
def _plain(*names):
    """The model's calls of the named kernels ("flash", "ssd", "moe")
    through their plain versions, on the card (a check only: the port
    always calls the kernels)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gemm as mg
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models import layers as ly
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import ssm as ssm_mod

    sites = {
        "flash": (ly, "flash_attention", fa.flash_attention_plain),
        "ssd": (ssm_mod, "ssd_scan",
                lambda *a, chunk: ss.ssd_scan_plain(*a, chunk=chunk)[0]),
        "moe": (moe_mod, "moe_grouped_gemm", mg.moe_grouped_gemm_plain),
    }
    saved = [(sites[n][0], sites[n][1], getattr(sites[n][0], sites[n][1])) for n in names]
    try:
        for n in names:
            mod, attr, plain = sites[n]
            setattr(mod, attr, plain)
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


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


def _flash_checks(fa, checks, tag):
    """Each (label, (B, H, KV, Sq, Sk, D), kwargs) of ``checks`` through
    the attention kernel against its plain version, fp32 and bf16, within
    FLASH_TOL.  Returns the largest fp32 error."""
    import torch

    worst = 0.0
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
        print(f"[{tag}] {label}: q {shape[:2] + shape[3:4] + shape[5:]} "
              f"over {shape[2]} KV heads x {shape[4]} keys, {kw}: max err fp32 "
              f"{errs['float32']:.3g}, bf16 {errs['bfloat16']:.3g}", flush=True)
    return worst


def _path_flash_checks(H, KV, D):
    """The serving paths' attention shapes for H query heads over KV heads
    of D: the prefill of LM_PREFILL and the decode of LM_SLOTS sequences
    over an LM_SMAX cache at DECODE_POSITIONS."""
    B, S = LM_PREFILL
    checks = [("prefill", (B, H, KV, S, S, D), dict(causal=True))]
    for pos in DECODE_POSITIONS:
        checks.append((f"decode pos {pos}", (LM_SLOTS, H, KV, 1, LM_SMAX, D),
                       dict(causal=True, q_offset=pos)))
    return checks


def phase_flash_kernel(fa):
    """The attention kernel against its plain version at the sweep, prefill
    and decode shapes (fp32 and bf16), and its times at the prefill and
    decode shapes in bf16.  Returns the JSON numbers: the decode at the
    full cache (position 2047), the serving path's launch."""
    import torch
    import torch.nn.functional as F

    checks = []
    for i, (b, h, sq, sk, d, causal, window, softcap) in enumerate(FLASH_SWEEP):
        checks.append((f"sweep {i}", (b, h, h, sq, sk, d), dict(
            causal=causal, window=window, softcap=softcap)))
    worst = _flash_checks(fa, checks + FLASH_HEAD_DIM_CHECKS + _path_flash_checks(16, 8, 128),
                          "flash kernel")

    # times in bf16 (the model's dtype), L2 flushed before each call: the
    # internlm2 prefill and decode, and kimi-k2's decode (64 heads over 8
    # KV heads of 112)
    B, S = LM_PREFILL
    timed = [("prefill", (B, 16, 8, S, S, 128), dict(causal=True), None)]
    timed += [(f"decode pos {pos}", (LM_SLOTS, 16, 8, 1, LM_SMAX, 128),
               dict(causal=True, q_offset=pos), pos) for pos in DECODE_POSITIONS]
    timed += [(f"kimi decode pos {pos}", (LM_SLOTS, 64, 8, 1, LM_SMAX, 112),
               dict(causal=True, q_offset=pos), pos) for pos in DECODE_POSITIONS]
    rows = {}
    for label, (b, h, kv, sq, sk, d), kw, pos in timed:
        q, k, v = _flash_qkv(7, b, h, kv, sq, sk, d, torch.bfloat16)
        kernel = lambda: fa.flash_attention(q, k, v, **kw)
        _bit_stable(f"flash {label}", kernel)
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
    out.update(_prefill_nums(rows["prefill"]))
    out.update(_shape_nums("kimi_decode", rows[f"kimi decode pos {DECODE_POSITIONS[-1]}"]))
    return out


def _bit_stable(tag, fn):
    """Fail unless two calls of ``fn`` give the same bits (the kernels sum
    in a fixed order: no atomics)."""
    import torch

    a, b = fn(), fn()
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError(f"{tag}: two runs differ (max "
                             f"{(a.float() - b.float()).abs().max().item()})")
    print(f"[bits] {tag}: two runs give the same bits", flush=True)


def phase_lm(fa):
    """internlm2-1.8b on the card: prefill through the kernel against the
    plain attention, fp32 card against CPU at 2 layers, decode against
    forward, then the main path (ServeEngine, counts set to 0 just before
    and read just after) and one profiled tick.  Returns the path's
    flash launches."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import TransformerLM

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
    routes = _routes(fa.flash_attention)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = model.prefill(toks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_launch = fa.flash_attention.launches - before
    _check_wgmma("lm prefill", routes, _routes(fa.flash_attention), [cfg.n_layers])
    warm = _warm_prefill(model, toks)
    with _plain("flash"):
        want = model.prefill(toks)
    if not (torch.isfinite(got[:, : cfg.vocab]).all() and got.shape == (B, model.vp)):
        raise AssertionError("prefill logits not finite or of the wrong shape")
    if n_launch != cfg.n_layers:
        raise AssertionError(f"prefill launched the kernel {n_launch} times")
    d_pre = (got - want)[:, : cfg.vocab].abs().max().item()
    agree = int((got.argmax(-1) == want.argmax(-1)).sum().item())
    print(f"[lm] prefill {B} x {S} tokens, bf16: {wall:.3f} s (first call), "
          f"{warm:.3f} s (second call), {n_launch} kernel launches, all on the "
          f"wgmma route; against the plain attention: max abs "
          f"logit diff {d_pre:.4g} (logits in [{got[:, :cfg.vocab].min().item():.3f}, "
          f"{got[:, :cfg.vocab].max().item():.3f}]), argmax agrees on {agree} of "
          f"{B}", flush=True)
    _gate_prefill("lm", d_pre, want[:, : cfg.vocab])

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

    errs, agree = _decode_vs_forward(card_m, 16, 2)
    print(f"[lm] decode vs forward, 2 layers fp32 on the card, 16 positions: "
          f"max err per position {' '.join(f'{e:.2g}' for e in errs)}; argmax "
          f"agrees at {agree} of 16", flush=True)
    if not (errs[0] < 1e-3 and max(errs) < 1e-2 and agree == 16):
        raise AssertionError("fp32 decode disagrees with the forward")
    del card_m
    errs, agree = _decode_vs_forward(model, 16, LM_SLOTS)
    print(f"[lm] decode vs forward, {cfg.n_layers} layers bf16, {LM_SLOTS} "
          f"sequences, 16 positions: max err per position "
          f"{' '.join(f'{e:.2g}' for e in errs)}; argmax agrees on all "
          f"sequences at {agree} of 16 positions", flush=True)
    if not all(np.isfinite(errs)):
        raise AssertionError("bf16 decode or forward not finite")

    # the main path: ServeEngine at launch/serve.py's defaults, smax 2048
    # and 128 new tokens each
    engine, reqs = _engine(model)
    torch.cuda.synchronize()
    fa.flash_attention.launches = 0
    stats = engine.run()
    launches = fa.flash_attention.launches
    ms_tick = _serve_checks("lm serve", model, stats, reqs,
                            {"flash": (launches, cfg.n_layers)})
    _teacher_forced("lm serve", model, reqs)
    _profile_tick("lm profile", model, ms_tick,
                  {"flash_attention": ("flash_decode", "flash_tiled", "flash_wgmma")})
    return launches


def _warm_prefill(model, toks):
    """Seconds of a second, warm call of ``model.prefill`` (the allocator's
    blocks and the kernels' first-launch costs already in place)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.prefill(toks)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _routes(*counted):
    """The launches per route of each kernel wrapper in ``counted``."""
    return [dict(c.launches_by_route) for c in counted]


def _check_wgmma(tag, before, after, want):
    """Fail unless every launch between the two ``_routes`` readings went
    through the wgmma route: ``want`` launches per wrapper."""
    for b, a, n in zip(before, after, want):
        moved = {r: a[r] - b[r] for r in a}
        if moved["wgmma"] != n or sum(moved.values()) != n:
            raise AssertionError(f"{tag}: the bf16 prefill's launches by route were "
                                 f"{moved}, expected {n} on the wgmma route")


def _gate_prefill(tag, d_pre, want):
    """Fail unless the kernel path's prefill logits are within PREFILL_RTOL
    of the largest plain logit (``want``, the vocab's columns)."""
    lim = PREFILL_RTOL * want.abs().max().item()
    print(f"[{tag}] prefill against the plain path: max abs logit diff "
          f"{d_pre:.4g}, limit {lim:.4g} ({PREFILL_RTOL} of the largest plain "
          f"logit)", flush=True)
    if not d_pre <= lim:
        raise AssertionError(f"{tag}: bf16 prefill through the kernels disagrees "
                             f"with the plain path ({d_pre} > {lim})")


def _decode_vs_forward(m, n_pos, batch):
    """Logits of ``n_pos`` decode steps against the forward's at the same
    positions (seeded tokens): the max error per position, and the number
    of positions where the argmax agrees on every sequence."""
    import torch

    vocab = m.cfg.vocab
    tk = torch.randint(0, vocab, (batch, n_pos),
                       generator=torch.Generator().manual_seed(4)).cuda()
    full = m._logits(m.forward(tk))[..., :vocab]
    cache = m.cache_struct(batch, n_pos)
    errs, agree = [], 0
    for t in range(n_pos):
        cache, lg = m.decode_step(cache, tk[:, t], t)
        lg = lg[:, :vocab]
        errs.append((lg - full[:, t]).abs().max().item())
        agree += int((lg.argmax(-1) == full[:, t].argmax(-1)).all().item())
    return errs, agree


def _requests(n, max_tokens):
    from repro_torch.serve import Request

    return [Request(rid=i, prompt=[1 + i % 13, 2, 3], max_tokens=max_tokens)
            for i in range(n)]


def _engine(model):
    """A ServeEngine at launch/serve.py's defaults (16 requests of
    ``[1 + i % 13, 2, 3]``, 8 slots) with smax LM_SMAX and LM_MAX_TOKENS
    new tokens each, the requests submitted."""
    from repro_torch.serve import ServeEngine

    engine = ServeEngine(model, n_slots=LM_SLOTS, smax=LM_SMAX)
    reqs = _requests(LM_REQUESTS, LM_MAX_TOKENS)
    for r in reqs:
        engine.submit(r)
    return engine, reqs


def _serve_checks(tag, model, stats, reqs, launches):
    """Prints the engine run's numbers and checks it: every request done
    with its tokens in the vocabulary, and each kernel of ``launches``
    (name -> (count, per tick)) launched its count per tick.  Returns the
    mean ms per tick."""
    vocab = model.cfg.vocab
    ms_tick = 1e3 * stats["wall_s"] / stats["ticks"]
    counts = ", ".join(f"{k} launches {n} ({n / stats['ticks']:.1f} per tick)"
                       for k, (n, _) in launches.items())
    print(f"[{tag}] {LM_REQUESTS} requests, {LM_SLOTS} slots, smax {LM_SMAX}, "
          f"{LM_MAX_TOKENS} new tokens each: {stats['tokens']} tokens over "
          f"{stats['ticks']} ticks in {stats['wall_s']:.3f} s: "
          f"{stats['tok_per_s']:.1f} tokens/s, {ms_tick:.3f} ms per tick; "
          f"{counts}", flush=True)
    for name, (n, per_tick) in launches.items():
        if n != per_tick * stats["ticks"]:
            raise AssertionError(f"{tag}: {name} launched {n} times, expected "
                                 f"{per_tick} per tick")
    if not all(r.done for r in reqs) or stats["tokens"] != LM_REQUESTS * (LM_MAX_TOKENS + 1):
        raise AssertionError(f"{tag}: the engine did not finish every request")
    if not all(0 <= t < vocab for r in reqs for t in r.out):
        raise AssertionError(f"{tag}: the engine emitted a token outside the vocabulary")
    return ms_tick


def _teacher_forced(tag, model, reqs):
    """The first wave (admitted at position 0, on a clean cache) against a
    teacher-forced forward of the same sequences."""
    import torch

    vocab = model.cfg.vocab
    first = reqs[:LM_SLOTS]
    seqs = torch.tensor([r.prompt[:1] + r.out for r in first], device="cuda")
    with torch.no_grad():
        pred = model._logits(model.forward(seqs[:, :-1]))[..., :vocab].argmax(-1)
    gen_from = len(first[0].prompt) - 1  # positions whose next token was generated
    tf_agree = (pred[:, gen_from:] == seqs[:, gen_from + 1:]).float().mean().item()
    print(f"[{tag}] first wave's {seqs.shape[1] - 1 - gen_from} generated "
          f"tokens per request against a teacher-forced {model.cfg.dtype} forward: "
          f"{100 * tf_agree:.1f}% agree", flush=True)


def _profile_tick(tag, model, ms_tick, kernels):
    """One profiled tick (8 busy slots, past the prompt feed): the
    device's busy share and operation count, and the tick's device time
    split into the kernels named in ``kernels`` (name -> key substrings),
    the matrix products (cuBLAS) and the rest (copies, casts, norms, ...)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import ServeEngine

    engine = ServeEngine(model, n_slots=LM_SLOTS, smax=LM_SMAX)
    for r in _requests(LM_SLOTS, 16):
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
    print(f"[{tag}] one tick at position {engine.pos - 1}: wall {1e3 * wall:.3f} "
          f"ms profiled, device busy {dev_ms:.3f} ms ({100 * dev_ms / 1e3 / wall:.1f}% "
          f"of the profiled wall, {100 * dev_ms / ms_tick:.1f}% of the engine run's "
          f"mean tick), {n_kernels} device operations", flush=True)
    split = {name: 0.0 for name in kernels}
    split.update(matmul=0.0, other=0.0)
    for a in rows:
        key = a.key.lower()
        part = next((name for name, subs in kernels.items()
                     if any(sub in key for sub in subs)), None)
        if part is None:
            part = ("matmul" if any(w in key for w in ("gemm", "nvjet", "gemv"))
                    else "other")
        split[part] += _device_us(a) / 1e3
    print(f"[{tag}] device time split: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in split.items()), flush=True)
    for a in rows[:10]:
        print(f"[{tag}]   {_device_us(a) / 1e3:9.3f} ms {a.count:5d}x "
              f"{a.key[:70]}", flush=True)


# ----------------------------------------------------------- mamba2, MoE
def _free():
    """Returns the memory of the models freed so far to the card."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _rel_err(got, want):
    """Largest difference relative to the largest magnitude of ``want``."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp(min=1e-30)).item()


def _ssd_inputs(seed, b, s, h, hd, ds, dtype, wide=False):
    """Seeded scan inputs on the card: x, dt = softplus(normal), mamba2's
    A = -linspace(1, 16, h), B and C.  With ``wide``, x, B and C are
    views of one [b, s, h hd + 2 ds] projection (strided rows)."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def draw(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    if wide:
        proj = draw(b, s, h * hd + 2 * ds).to(dtype)
        x = proj[..., : h * hd].view(b, s, h, hd)
        Bm = proj[..., h * hd: h * hd + ds].view(b, s, 1, ds)
        Cm = proj[..., h * hd + ds:].view(b, s, 1, ds)
    else:
        x, Bm, Cm = draw(b, s, h, hd).to(dtype), draw(b, s, ds).to(dtype), draw(b, s, ds).to(dtype)
    dt = F.softplus(draw(b, s, h))
    A = -torch.linspace(1.0, 16.0, h, device="cuda")
    return x, dt, A, Bm, Cm


def _ssd_bound(b, s, h, hd, ds, q, elt, g=1):
    """Least time of the scan on the card: per (batch row, group, chunk)
    the causal C B^T (q (q + 1) / 2 pairs; B and C are shared by the
    group's heads, and the mma route forms it once for them), per (batch
    row, head, chunk) the causal W x product, the carried state's C h and
    the state update (q hd ds each), 2 flops a product, at the bf16
    tensor-core peak (fp32 peak for fp32 data); against x, y written or
    read once, dt, B and C read once, at the HBM rate."""
    pairs = q * (q + 1) // 2
    flops = b * (s // q) * (g * 2 * pairs * ds + h * (2 * pairs * hd + 4 * q * hd * ds))
    n_bytes = elt * (2 * b * s * h * hd + 2 * b * s * ds) + 4 * (b * s * h + h)
    ops_ms = flops / (BF16_FLOP_PER_S if elt == 2 else FP32_FLOP_PER_S) * 1e3
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes"), flops, n_bytes


def phase_ssd_kernel(ss):
    """The SSD kernel against its plain version at the sweep shapes of
    ``tests/test_kernels.py``, the smoke config's chunk of 32, and
    mamba2-1.3b's prefill shape (plain and as views of one projection),
    bf16 on the mma route and fp32 on the FMA route; at the prefill shape
    in bf16, the same bits on two runs and its times (the FMA route's in
    fp32 beside them).  Returns the JSON numbers (the prefill shape: the
    path's launches)."""
    import torch

    from repro_torch.configs import get_config

    cfg = get_config(MAMBA_ARCH)
    B, S = LM_PREFILL
    full = (B, S, cfg.ssm.n_heads(cfg.d_model), cfg.ssm.head_dim, cfg.ssm.d_state,
            cfg.ssm.chunk)
    checks = [(f"sweep {i}", shape, False) for i, shape in enumerate(SSD_SWEEP)]
    checks += [("smoke chunk 32", (2, 96, 4, 16, 16, 32), False),
               ("prefill", full, False),
               ("prefill, x, B and C views of one projection", full, True)]
    worst = 0.0
    for seed, (label, (b, s, h, hd, ds, q), wide) in enumerate(checks):
        errs = {}
        for dtype in ("float32", "bfloat16"):
            args = _ssd_inputs(seed, b, s, h, hd, ds, getattr(torch, dtype), wide)
            before = _routes(ss.ssd_scan)
            got = ss.ssd_scan(*args, chunk=q)
            _check_route(f"ssd {label} {dtype}", before, _routes(ss.ssd_scan),
                         ["mma" if dtype == "bfloat16" else "fma"])
            want = ss.ssd_scan_plain(*args, chunk=q)[0]
            torch.cuda.synchronize()
            errs[dtype] = _rel_err(got, want)
            if not errs[dtype] <= KERNEL_RTOL[dtype]:
                raise AssertionError(f"ssd kernel != plain at {label} {dtype}: "
                                     f"relative err {errs[dtype]} (tol {KERNEL_RTOL[dtype]})")
            if dtype == "float32":
                worst = max(worst, (got - want).abs().max().item())
            del args, got, want
        print(f"[ssd kernel] {label}: x [{b}, {s}, {h}, {hd}], d_state {ds}, chunk "
              f"{q}: max err relative to the largest output, fp32 (fma route) "
              f"{errs['float32']:.3g}, bf16 (mma route) {errs['bfloat16']:.3g}", flush=True)
    args = _ssd_inputs(99, *full[:5], torch.bfloat16)
    kernel = lambda: ss.ssd_scan(*args, chunk=full[5])
    plain = lambda: ss.ssd_scan_plain(*args, chunk=full[5])
    _bit_stable("ssd_scan mma route, prefill bf16", kernel)
    ms = _device_ms(kernel, 10, flush=True)
    plain_ms = _device_ms(plain, 2, flush=True)
    # the FMA route's time at the same shape (fp32), in the same run
    args32 = _ssd_inputs(99, *full[:5], torch.float32)
    fma_ms = _device_ms(lambda: ss.ssd_scan(*args32, chunk=full[5]), 3, flush=True)
    del args32
    bound, by, flops, n_bytes = _ssd_bound(*full, 2)
    print(f"[ssd kernel] prefill bf16: device time per call, L2 flushed: kernel "
          f"(mma route) {ms:.4f} ms, plain {plain_ms:.4f} ms, no library call "
          f"computes it; bound {bound:.6f} ms by {by} ({flops} flops, {n_bytes} "
          f"bytes): the mma route at {100 * bound / ms:.1f}% of its bound; fp32 "
          f"on the FMA route {fma_ms:.4f} ms", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound,
                bound_by=by, max_abs_err=worst, fma_ms=fma_ms)


def phase_mamba(ss, fa, mg):
    """mamba2-1.3b on the card: fp32 card (kernel) against CPU (plain) at 2
    layers and decode against forward; then the main path, the prefill
    of 4 x 2048 tokens and the ServeEngine run, with the launch counts set
    to 0 just before and read just after; the prefill against the plain
    scan; one profiled tick.  Returns the path's ssd_scan launches, in
    all and by route."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import TransformerLM

    _free()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(MAMBA_ARCH)
    # 2 layers at full width in fp32: the card's kernel path against the
    # CPU's plain path, and decode against forward on the card
    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    cpu_m = TransformerLM(cfg2, device="cpu").init(torch.Generator().manual_seed(2))
    card_m = TransformerLM(cfg2, device="cuda")
    card_m.load_state_dict(cpu_m.state_dict())
    toks2 = torch.randint(0, cfg.vocab, (2, 512), generator=torch.Generator().manual_seed(3))
    h_card = card_m.forward(toks2.cuda())
    h_cpu = cpu_m.forward(toks2)
    l_card, l_cpu = card_m._logits(h_card[:, -1]).cpu(), cpu_m._logits(h_cpu[:, -1])
    d_h = (h_card.cpu() - h_cpu).abs().max().item()
    d_l = (l_card - l_cpu)[:, : cfg.vocab].abs().max().item()
    print(f"[mamba] 2 layers, full width, fp32, 2 x 512 tokens ("
          f"{512 // cfg.ssm.chunk} chunks of {cfg.ssm.chunk}): card (kernel) vs "
          f"cpu (plain): hidden max diff "
          f"{d_h:.3g}, last logits max diff {d_l:.3g} (atol {LM_FP32_ATOL})", flush=True)
    if not max(d_h, d_l) <= LM_FP32_ATOL:
        raise AssertionError("the card's fp32 mamba2 disagrees with the CPU's")
    del cpu_m, h_card
    errs, agree = _decode_vs_forward(card_m, 16, 2)
    print(f"[mamba] decode vs forward, 2 layers fp32 on the card, 16 positions: "
          f"max err per position {' '.join(f'{e:.2g}' for e in errs)}; argmax "
          f"agrees at {agree} of 16", flush=True)
    if not (errs[0] < 1e-3 and max(errs) < 1e-2 and agree == 16):
        raise AssertionError("fp32 mamba2 decode disagrees with the forward")
    del card_m
    _free()

    t0 = time.perf_counter()
    model = TransformerLM(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    s = cfg.ssm
    print(f"[mamba] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"d_inner {s.d_inner(cfg.d_model)}, {s.n_heads(cfg.d_model)} SSM heads "
          f"of {s.head_dim}, d_state {s.d_state}, chunk {s.chunk}, vocab "
          f"{cfg.vocab} padded to {model.vp}; "
          f"{sum(p.numel() for p in model.parameters())} parameters in "
          f"{cfg.dtype} (param_count {cfg.param_count()}), initialised on the "
          f"card in {time.perf_counter() - t0:.1f} s", flush=True)

    # the main path: the prefill, then the ServeEngine run
    B, S = LM_PREFILL
    toks = torch.randint(0, cfg.vocab, (B, S), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(1))
    engine, reqs = _engine(model)
    torch.cuda.synchronize()
    for counted in (ss.ssd_scan, fa.flash_attention, mg.moe_grouped_gemm):
        counted.launches = 0
    routes0 = _routes(ss.ssd_scan)
    t0 = time.perf_counter()
    got = model.prefill(toks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_pre = ss.ssd_scan.launches
    _check_route("mamba2 prefill", routes0, _routes(ss.ssd_scan), ["mma"])
    stats = engine.run()
    launches = ss.ssd_scan.launches
    by_route = {r: n - routes0[0][r] for r, n in ss.ssd_scan.launches_by_route.items()}
    others = fa.flash_attention.launches + mg.moe_grouped_gemm.launches
    if not (torch.isfinite(got[:, : cfg.vocab]).all() and got.shape == (B, model.vp)):
        raise AssertionError("mamba2 prefill logits not finite or of the wrong shape")
    if n_pre != cfg.n_layers or others:
        raise AssertionError(f"mamba2 prefill launched ssd_scan {n_pre} times "
                             f"and the other kernels {others} times")
    warm = _warm_prefill(model, toks)
    with _plain("ssd"):
        want = model.prefill(toks)
    d_pre = (got - want)[:, : cfg.vocab].abs().max().item()
    agree = int((got.argmax(-1) == want.argmax(-1)).sum().item())
    print(f"[mamba] prefill {B} x {S} tokens, bf16: {wall:.3f} s (first call), "
          f"{warm:.3f} s (second call), {n_pre} ssd_scan launches, all on the "
          f"mma route; against the "
          f"plain scan: max abs logit diff {d_pre:.4g} (logits in "
          f"[{got[:, :cfg.vocab].min().item():.3f}, "
          f"{got[:, :cfg.vocab].max().item():.3f}]), argmax agrees on {agree} "
          f"of {B}", flush=True)
    _gate_prefill("mamba", d_pre, want[:, : cfg.vocab])
    h = engine.cache["h"]
    print(f"[mamba serve] recurrent state {list(h.shape)} fp32, "
          f"{h.numel() * h.element_size()} bytes", flush=True)
    ms_tick = _serve_checks("mamba serve", model, stats, reqs,
                            {"ssd_scan": (launches - n_pre, 0)})
    _teacher_forced("mamba serve", model, reqs)
    _profile_tick("mamba profile", model, ms_tick, {"ssd_scan": ("ssd_scan",)})
    print(f"[mamba] peak device memory {torch.cuda.max_memory_allocated()} bytes",
          flush=True)
    return launches, by_route


def _moe_inputs(seed, t, d, f, e, dtype, gs):
    """Seeded x [t, d] and w [e, d, f] (scaled 1/sqrt(d), as the model's)
    on the card, and the group sizes as a device int32 tensor."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(t, d, generator=gen, device="cuda").to(dtype)
    w = torch.randn(e, d, f, generator=gen, device="cuda").mul_(d ** -0.5).to(dtype)
    return x, w, torch.tensor(gs, dtype=torch.int32, device="cuda")


def _routed(seed, t, e, empty=()):
    """Group sizes: top-1 routing of t tokens to e experts (uniform), or,
    with ``empty``, a Dirichlet share of 0.9 t with those experts empty
    (the sweep of tests/test_kernels.py)."""
    rng = np.random.default_rng(seed)
    if not empty:
        return np.bincount(rng.integers(0, e, t), minlength=e).tolist()
    share = rng.dirichlet(np.ones(e))
    share[list(empty)] = 0.0
    return np.floor(share / share.sum() * t * 0.9).astype(int).tolist()


def _routed_topk(seed, tokens, k, e):
    """Group sizes: top-k routing of ``tokens`` tokens, each to k distinct
    experts of e (uniform): tokens * k rows."""
    rng = np.random.default_rng(seed)
    hits = np.concatenate([rng.choice(e, k, replace=False) for _ in range(tokens)])
    return np.bincount(hits, minlength=e).tolist()


def _moe_bound(t, d, f, e, gs, elt):
    """Least time of the grouped GEMM on the card: 2 flops per routed row
    and product at the bf16 tensor-core peak (fp32 peak for fp32), against
    the routed rows of x, the weights of the experts hit, the output and
    the group sizes, each moved once, at the HBM rate."""
    rows, hit = sum(gs), sum(1 for g in gs if g > 0)
    flops = 2 * rows * d * f
    n_bytes = elt * (rows * d + hit * d * f + t * f) + 4 * e
    ops_ms = flops / (BF16_FLOP_PER_S if elt == 2 else FP32_FLOP_PER_S) * 1e3
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes"), flops, n_bytes


def _event_ms(fn, reps):
    """Device time per call from events around each call, L2 flushed
    before it, for a function that waits on the host inside (the plain
    grouped GEMM reads the group sizes): its host time is included."""
    import torch

    buf = torch.empty(2**25, dtype=torch.float32, device="cuda")
    fn()
    total = 0.0
    for _ in range(reps):
        buf.fill_(1.0)
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        total += t0.elapsed_time(t1)
    return total / reps


def _grouped_mm(x, w, gs, want):
    """``torch._grouped_mm`` on the same inputs, the yardstick (the port
    never calls it): a callable and a note, or None and the reason."""
    import torch

    if not hasattr(torch, "_grouped_mm"):
        return None, "torch has no _grouped_mm"
    offs = torch.cumsum(gs, 0, dtype=torch.int32)
    rows = int(gs.sum().item())
    reason = ""
    for label, wl in (("w as stored", w),
                      ("w column-major", w.transpose(1, 2).contiguous().transpose(1, 2))):
        fn = lambda wl=wl: torch._grouped_mm(x, wl, offs=offs)
        try:
            out = fn()
            torch.cuda.synchronize()
        except (RuntimeError, TypeError, ValueError) as err:
            reason = f"torch._grouped_mm refused ({label}): {str(err).splitlines()[0]}"
            continue
        return fn, f"{label}, max diff to plain {_rel_err(out[:rows], want[:rows]):.3g} relative"
    return None, reason


def phase_moe_kernel(mg):
    """The grouped-GEMM kernel against its plain version at the sweep
    shapes of ``tests/test_kernels.py`` (an empty expert, rows past the
    sum) and llama4-scout's decode (T = 8, gate/up and down) and prefill
    (T = 8192, gate/up and down) shapes, fp32 and bf16; times at those four
    shapes in bf16
    beside the bound and ``torch._grouped_mm``.  Returns the JSON numbers
    (the decode gate/up shape: the serving path's launches)."""
    import torch

    from repro_torch.configs import get_config

    cfg = get_config(MOE_ARCH)
    D, Fe, E = cfg.d_model, cfg.moe.d_ff_expert, cfg.moe.n_experts
    kimi = get_config(KIMI_ARCH)
    KD, KF, KE, KK = kimi.d_model, kimi.moe.d_ff_expert, kimi.moe.n_experts, kimi.moe.top_k
    B, S = LM_PREFILL
    big = [("decode gate/up", (LM_SLOTS, D, Fe, E), _routed(1, LM_SLOTS, E)),
           ("decode down", (LM_SLOTS, Fe, D, E), _routed(1, LM_SLOTS, E)),
           ("prefill gate/up", (B * S, D, Fe, E), _routed(2, B * S, E)),
           ("prefill down", (B * S, Fe, D, E), _routed(2, B * S, E)),
           ("kimi decode gate/up", (LM_SLOTS * KK, KD, KF, KE),
            _routed_topk(3, LM_SLOTS, KK, KE)),
           ("kimi decode down", (LM_SLOTS * KK, KF, KD, KE),
            _routed_topk(3, LM_SLOTS, KK, KE))]
    checks = [(f"sweep {i}", shape, _routed(10 + i, shape[0], shape[3], empty=(1,)))
              for i, shape in enumerate(MOE_SWEEP)] + big
    worst = 0.0
    for seed, (label, (t, d, f, e), gs) in enumerate(checks):
        errs = {}
        for dtype in ("float32", "bfloat16"):
            x, w, g = _moe_inputs(seed, t, d, f, e, getattr(torch, dtype), gs)
            got = mg.moe_grouped_gemm(x, w, g)
            want = mg.moe_grouped_gemm_plain(x, w, g)
            torch.cuda.synchronize()
            errs[dtype] = _rel_err(got, want)
            if not (errs[dtype] <= KERNEL_RTOL[dtype] and not got[sum(gs):].any()):
                raise AssertionError(f"moe kernel != plain at {label} {dtype}: "
                                     f"relative err {errs[dtype]} (tol {KERNEL_RTOL[dtype]})")
            if dtype == "float32":
                worst = max(worst, (got - want).abs().max().item())
            del x, w, g, got, want
        print(f"[moe kernel] {label}: x [{t}, {d}], w [{e}, {d}, {f}], {sum(gs)} rows "
              f"over {sum(1 for v in gs if v)} experts: max err relative to the "
              f"largest output, fp32 {errs['float32']:.3g}, bf16 {errs['bfloat16']:.3g}",
              flush=True)
    _free()
    rows = {}
    for label, (t, d, f, e), gs in big:
        x, w, g = _moe_inputs(7, t, d, f, e, torch.bfloat16, gs)
        want = mg.moe_grouped_gemm_plain(x, w, g)
        kernel = lambda: mg.moe_grouped_gemm(x, w, g)
        decode = mg.route(x.dtype, t, e) == "stream"
        if decode:
            _bit_stable(f"moe {label}", kernel)
        ms = _device_ms(kernel, 20 if decode else 5, flush=True)
        plain_ms = _event_ms(lambda: mg.moe_grouped_gemm_plain(x, w, g), 5)
        lib, note = _grouped_mm(x, w, g, want)
        library_ms = _device_ms(lib, 20 if decode else 5, flush=True) if lib else None
        bound, by, flops, n_bytes = _moe_bound(t, d, f, e, gs, 2)
        lib_txt = f"{library_ms:.4f} ms ({note})" if lib else f"none ({note})"
        print(f"[moe kernel] {label} bf16 ({sum(1 for v in gs if v)} experts hit): "
              f"device time per call, L2 flushed: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms (host included: it reads the group sizes), "
              f"torch._grouped_mm {lib_txt}; bound {bound:.6f} ms by {by} "
              f"({flops} flops, {n_bytes} bytes; {100 * bound / ms:.1f}% of the "
              f"kernel's time)", flush=True)
        rows[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                           bound_ms=bound, bound_by=by)
        del x, w, g, want, lib
        _free()
    out = dict(rows["decode gate/up"])
    out["max_abs_err"] = worst
    out.update(_prefill_nums(rows["prefill gate/up"]))
    out.update(_shape_nums("kimi_decode", rows["kimi decode gate/up"]))
    return out


def phase_moe(mg, fa):
    """llama4-scout at full width and MOE_LAYERS of its 48 layers on the
    card: at 2 layers in fp32 the kernel path against the plain path and
    decode against forward; then the main path, the prefill of 4 x 2048
    tokens and the ServeEngine run, with the launch counts set to 0 just
    before and read just after; the prefill against the plain path; one
    profiled tick.  Returns the path's launches per kernel."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import TransformerLM

    _free()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS)
    # 2 layers at full width in fp32 (16 GB of experts): the kernels
    # against their plain versions on the card (the CPU is too slow for
    # them; the CPU tests hold the plain path to JAX), and decode against
    # forward
    m2 = TransformerLM(dataclasses.replace(cfg, n_layers=2, dtype="float32"),
                       device="cuda").init(torch.Generator(device="cuda").manual_seed(2))
    toks2 = torch.randint(0, cfg.vocab, (2, 256),
                          generator=torch.Generator().manual_seed(3)).cuda()
    h_k = m2.forward(toks2)
    with _plain("flash", "moe"):
        h_p = m2.forward(toks2)
    d_h = (h_k - h_p).abs().max().item()
    d_l = (m2._logits(h_k[:, -1]) - m2._logits(h_p[:, -1]))[:, : cfg.vocab].abs().max().item()
    print(f"[moe] 2 layers, full width, fp32, 2 x 256 tokens: kernels vs plain "
          f"on the card: hidden max diff {d_h:.3g}, last logits max diff {d_l:.3g} "
          f"(atol {LM_FP32_ATOL})", flush=True)
    if not max(d_h, d_l) <= LM_FP32_ATOL:
        raise AssertionError("llama4 fp32: the kernels disagree with the plain path")
    del h_k, h_p
    errs, agree = _decode_vs_forward(m2, 16, 2)
    print(f"[moe] decode vs forward, 2 layers fp32 on the card, 16 positions: "
          f"max err per position {' '.join(f'{e:.2g}' for e in errs)}; argmax "
          f"agrees at {agree} of 16", flush=True)
    if not (errs[0] < 1e-3 and max(errs) < 1e-2 and agree == 16):
        raise AssertionError("fp32 llama4 decode disagrees with the forward")
    del m2
    _free()

    t0 = time.perf_counter()
    model = TransformerLM(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    e = cfg.moe
    print(f"[moe] {cfg.name} at {cfg.n_layers} of 48 layers: d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads over {cfg.n_kv_heads} KV heads, head_dim {cfg.hd}, "
          f"{e.n_experts} experts of d_ff {e.d_ff_expert}, top-{e.top_k}, vocab "
          f"{cfg.vocab} padded to {model.vp}; "
          f"{sum(p.numel() for p in model.parameters())} parameters in "
          f"{cfg.dtype} (param_count {cfg.param_count()}), initialised on the "
          f"card in {time.perf_counter() - t0:.1f} s", flush=True)

    # the main path: the prefill, then the ServeEngine run
    B, S = LM_PREFILL
    toks = torch.randint(0, cfg.vocab, (B, S), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(1))
    engine, reqs = _engine(model)
    torch.cuda.synchronize()
    fa.flash_attention.launches = 0
    mg.moe_grouped_gemm.launches = 0
    routes = _routes(mg.moe_grouped_gemm, fa.flash_attention)
    t0 = time.perf_counter()
    got = model.prefill(toks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pre = (mg.moe_grouped_gemm.launches, fa.flash_attention.launches)
    pre_routes = _routes(mg.moe_grouped_gemm, fa.flash_attention)
    stats = engine.run()
    launches = {"moe_gemm": mg.moe_grouped_gemm.launches,
                "flash_attention": fa.flash_attention.launches}
    _check_wgmma("moe prefill", routes, pre_routes, [3 * cfg.n_layers, cfg.n_layers])
    warm = _warm_prefill(model, toks)
    if not (torch.isfinite(got[:, : cfg.vocab]).all() and got.shape == (B, model.vp)):
        raise AssertionError("llama4 prefill logits not finite or of the wrong shape")
    if pre != (3 * cfg.n_layers, cfg.n_layers):
        raise AssertionError(f"llama4 prefill launched (moe_gemm, flash) {pre} times")
    with _plain("flash", "moe"):
        want = model.prefill(toks)
    d_pre = (got - want)[:, : cfg.vocab].abs().max().item()
    agree = int((got.argmax(-1) == want.argmax(-1)).sum().item())
    print(f"[moe] prefill {B} x {S} tokens, bf16: {wall:.3f} s (first call), "
          f"{warm:.3f} s (second call), {pre[0]} moe_gemm and {pre[1]} flash "
          f"launches, all on the wgmma routes; against the plain "
          f"path: max abs logit diff {d_pre:.4g} (logits in "
          f"[{got[:, :cfg.vocab].min().item():.3f}, "
          f"{got[:, :cfg.vocab].max().item():.3f}]), argmax agrees on {agree} "
          f"of {B}", flush=True)
    _gate_prefill("moe", d_pre, want[:, : cfg.vocab])
    ms_tick = _serve_checks("moe serve", model, stats, reqs, {
        "moe_gemm": (launches["moe_gemm"] - pre[0], 3 * cfg.n_layers),
        "flash_attention": (launches["flash_attention"] - pre[1], cfg.n_layers)})
    _teacher_forced("moe serve", model, reqs)
    _profile_tick("moe profile", model, ms_tick,
                  {"moe_gemm": ("moe_gemm", "moe_wgmma", "moe_stream"),
                   "flash_attention": ("flash_decode", "flash_tiled", "flash_wgmma")})
    print(f"[moe] peak device memory {torch.cuda.max_memory_allocated()} bytes",
          flush=True)
    return launches


def _check_route(tag, before, after, want):
    """Fail unless the launches between the two ``_routes`` readings all
    went through the route named in ``want`` for each wrapper, and some
    did."""
    for b, a, r in zip(before, after, want):
        moved = {k: a[k] - b[k] for k in a}
        if moved[r] == 0 or sum(moved.values()) != moved[r]:
            raise AssertionError(f"{tag}: launches by route were {moved}, expected "
                                 f"all on the {r} route")


def phase_kimi(mg, fa):
    """kimi-k2-1t-a32b at full width and KIMI_LAYERS of its 61 layers on the
    card, bf16: the main path (the prefill of 4 x 2048 tokens, on the
    wgmma routes, then the ServeEngine run, whose ticks go through flash's
    decode route at head_dim 112 and moe_gemm's streaming route), with the
    launch counts set to 0 just before and read just after; the prefill
    against the plain path; decode against forward; one profiled tick.
    Returns the path's launches per kernel."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import TransformerLM

    _free()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config(KIMI_ARCH), n_layers=KIMI_LAYERS)
    t0 = time.perf_counter()
    model = TransformerLM(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    e = cfg.moe
    print(f"[kimi] {cfg.name} at {cfg.n_layers} of 61 layers (the cut: one "
          f"layer's {e.n_experts} experts are "
          f"{3 * e.n_experts * cfg.d_model * e.d_ff_expert * 2} bytes in bf16, so "
          f"two layers do not fit the card): d_model {cfg.d_model}, {cfg.n_heads} "
          f"heads over {cfg.n_kv_heads} KV heads, head_dim {cfg.hd}, {e.n_experts} "
          f"experts of d_ff {e.d_ff_expert}, top-{e.top_k}, vocab {cfg.vocab} padded "
          f"to {model.vp}; {sum(p.numel() for p in model.parameters())} parameters "
          f"in {cfg.dtype} (param_count {cfg.param_count()}), initialised on the card "
          f"in {time.perf_counter() - t0:.1f} s; peak so far "
          f"{torch.cuda.max_memory_allocated()} bytes", flush=True)

    # the main path: the prefill, then the ServeEngine run
    B, S = LM_PREFILL
    toks = torch.randint(0, cfg.vocab, (B, S), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(1))
    engine, reqs = _engine(model)
    torch.cuda.synchronize()
    fa.flash_attention.launches = 0
    mg.moe_grouped_gemm.launches = 0
    routes = _routes(mg.moe_grouped_gemm, fa.flash_attention)
    t0 = time.perf_counter()
    got = model.prefill(toks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pre = (mg.moe_grouped_gemm.launches, fa.flash_attention.launches)
    pre_routes = _routes(mg.moe_grouped_gemm, fa.flash_attention)
    stats = engine.run()
    launches = {"moe_gemm": mg.moe_grouped_gemm.launches,
                "flash_attention": fa.flash_attention.launches}
    tick_routes = _routes(mg.moe_grouped_gemm, fa.flash_attention)
    _check_wgmma("kimi prefill", routes, pre_routes, [3 * cfg.n_layers, cfg.n_layers])
    _check_route("kimi ticks", pre_routes, tick_routes, ["stream", "decode"])
    print(f"[kimi] launches by route: prefill moe_gemm "
          f"{ {k: pre_routes[0][k] - routes[0][k] for k in routes[0]} }, flash "
          f"{ {k: pre_routes[1][k] - routes[1][k] for k in routes[1]} }; ticks "
          f"moe_gemm { {k: tick_routes[0][k] - pre_routes[0][k] for k in routes[0]} }, "
          f"flash { {k: tick_routes[1][k] - pre_routes[1][k] for k in routes[1]} }",
          flush=True)
    warm = _warm_prefill(model, toks)
    if not (torch.isfinite(got[:, : cfg.vocab]).all() and got.shape == (B, model.vp)):
        raise AssertionError("kimi prefill logits not finite or of the wrong shape")
    if pre != (3 * cfg.n_layers, cfg.n_layers):
        raise AssertionError(f"kimi prefill launched (moe_gemm, flash) {pre} times")
    with _plain("flash", "moe"):
        want = model.prefill(toks)
    d_pre = (got - want)[:, : cfg.vocab].abs().max().item()
    agree = int((got.argmax(-1) == want.argmax(-1)).sum().item())
    print(f"[kimi] prefill {B} x {S} tokens, bf16: {wall:.3f} s (first call), "
          f"{warm:.3f} s (second call), {pre[0]} moe_gemm and {pre[1]} flash "
          f"launches, all on the wgmma routes; against the plain path: max abs "
          f"logit diff {d_pre:.4g} (logits in [{got[:, :cfg.vocab].min().item():.3f}, "
          f"{got[:, :cfg.vocab].max().item():.3f}]), argmax agrees on {agree} "
          f"of {B}", flush=True)
    _gate_prefill("kimi", d_pre, want[:, : cfg.vocab])
    del got, want
    ms_tick = _serve_checks("kimi serve", model, stats, reqs, {
        "moe_gemm": (launches["moe_gemm"] - pre[0], 3 * cfg.n_layers),
        "flash_attention": (launches["flash_attention"] - pre[1], cfg.n_layers)})
    _teacher_forced("kimi serve", model, reqs)
    errs, agree = _decode_vs_forward(model, 16, LM_SLOTS)
    with _plain("flash", "moe"):
        errs_p, agree_p = _decode_vs_forward(model, 16, LM_SLOTS)
    tols = [max(KIMI_DECODE_ATOL, KIMI_DECODE_NOISE * e) for e in errs_p]
    print(f"[kimi] decode vs forward, {cfg.n_layers} layer bf16, {LM_SLOTS} "
          f"sequences, 16 positions: max err per position "
          f"{' '.join(f'{e:.2g}' for e in errs)}; argmax agrees on all sequences "
          f"at {agree} of 16 positions; the same through the plain versions: "
          f"{' '.join(f'{e:.2g}' for e in errs_p)}, argmax at {agree_p} of 16 "
          f"(tol per position: {KIMI_DECODE_ATOL}, or {KIMI_DECODE_NOISE}x the plain "
          f"path's error there)", flush=True)
    if not all(e <= t for e, t in zip(errs, tols)):
        raise AssertionError("kimi decode disagrees with the forward")
    _profile_tick("kimi profile", model, ms_tick,
                  {"moe_gemm": ("moe_gemm", "moe_wgmma", "moe_stream"),
                   "flash_attention": ("flash_decode", "flash_tiled", "flash_wgmma")})
    print(f"[kimi] peak device memory {torch.cuda.max_memory_allocated()} bytes",
          flush=True)
    return launches


def phase_kimi_serve(mg, fa, t):
    """kimi_serve: the attention kernel at kimi-k2's shapes (64 query heads
    over 8 KV heads of 112), then the model.  Returns the path's launches
    and the largest fp32 attention error."""
    from repro_torch.configs import get_config

    cfg = get_config(KIMI_ARCH)
    flash_err = _flash_checks(fa, _path_flash_checks(cfg.n_heads, cfg.n_kv_heads, cfg.hd),
                              "kimi flash kernel")
    t = _phase_done(f"flash_attention checks at {KIMI_ARCH}'s shapes", t)
    launches = phase_kimi(mg, fa)
    t = _phase_done(f"kimi serving (kimi-k2 at {KIMI_LAYERS} layer: prefill, "
                    "ServeEngine, decode, profile)", t)
    return launches, flash_err, t


def _prefill_nums(row):
    """A timed prefill row as the record's prefill_* numbers."""
    return {"prefill_ms": row["ms"], "prefill_bound_ms": row["bound_ms"],
            "prefill_library_ms": row["library_ms"]}


def _shape_nums(prefix, row):
    """A timed row at a second shape as the record's <prefix>_* numbers."""
    return {f"{prefix}_{k}": row[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")}


def _entry(name, stem, replaces, nums, launches, by_route=None):
    """One kernel's record of the JSON line (source csrc/<stem>.cu); the
    flash and moe_gemm records also carry their prefill row's times,
    waterfill's its chain bound, ssd_scan's its FMA route's time and its
    launches by route, sage_aggregate's its gather probe's time and its
    backward's times (``bwd_ms``, ``bwd_bound_ms``, ``bwd_library_ms``)."""
    return {
        "name": name,
        "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{stem}.cu",
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": nums["max_abs_err"],
        "ms": nums["ms"],
        "plain_ms": nums["plain_ms"],
        "bound_ms": nums["bound_ms"],
        "bound_by": nums["bound_by"],
        "library_ms": nums.get("library_ms"),
        **{k: v for k, v in nums.items()
           if k.startswith(("prefill_", "kimi_", "chain_", "fma_", "bwd_", "probe_"))},
        **({"launches_by_route": by_route} if by_route is not None else {}),
    }


def phase_mamba_serve(ss, fa, mg, t):
    ssd = phase_ssd_kernel(ss)
    t = _phase_done("ssd_scan kernel checks and times", t)
    launches, by_route = phase_mamba(ss, fa, mg)
    t = _phase_done("mamba2 serving (mamba2-1.3b: parity, decode, prefill, "
                    "ServeEngine, profile)", t)
    return _entry("ssd_scan", "ssd_scan", "src/repro/kernels/ssd_scan.py:83", ssd,
                  launches, by_route), t


def phase_moe_serve(mg, fa, t):
    from repro_torch.configs import get_config

    cfg = get_config(MOE_ARCH)
    # llama4-scout's attention: 40 query heads over 8 KV heads, so decode
    # runs the 4-head grouping with a partial second group (5 = 4 + 1)
    flash_err = _flash_checks(fa, _path_flash_checks(cfg.n_heads, cfg.n_kv_heads, cfg.hd),
                              "moe flash kernel")
    t = _phase_done(f"flash_attention checks at {MOE_ARCH}'s shapes", t)
    moe = phase_moe_kernel(mg)
    t = _phase_done("moe_gemm kernel checks and times", t)
    launches = phase_moe(mg, fa)
    t = _phase_done(f"MoE serving (llama4-scout at {MOE_LAYERS} layers: parity, "
                    "decode, prefill, ServeEngine, profile)", t)
    entry = _entry("moe_gemm", "moe_gemm", "src/repro/kernels/moe_gemm.py:69", moe,
                   launches["moe_gemm"])
    return entry, launches["flash_attention"], flash_err, t


def _phase_done(name, t0):
    print(f"[time] {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return time.perf_counter()


def phase_lm_serve(fa, t):
    """Phase 7: the attention kernel's checks and times, then the LM."""
    flash = phase_flash_kernel(fa)
    t = _phase_done("flash_attention kernel checks and times", t)
    launches = phase_lm(fa)
    t = _phase_done("LM serving (internlm2-1.8b: prefill, parity, decode, "
                    "ServeEngine, profile)", t)
    return flash, launches, t


def phase_sage_all(sa, wf, t):
    """Phase 6: the aggregation kernels' checks and times, then GraphSAGE."""
    sage, launches = phase_sage(sa, wf)
    t = _phase_done("GraphSAGE (graph, kernel checks, parity, training, "
                    "calibration, profile)", t)
    return sage, launches, t


def _sage_entry(sage, launches):
    return _entry("sage_aggregate", "sage_aggregate", "src/repro/kernels/sage_aggregate.py:83",
                  sage, launches["sage_aggregate"])


def _flash_entry(flash, launches):
    return _entry("flash_attention", "flash_attention",
                  "src/repro/kernels/flash_attention.py:102", flash, launches)


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=("sage", "lm_serve", "mamba_serve", "moe_serve",
                                       "kimi_serve"),
                    default=None, help="build the kernels and run this phase alone")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gemm as mg
    from repro_torch.kernels import sage_aggregate as sa
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels import waterfill as wf

    t_start = t = time.perf_counter()
    print(f"[device] {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    sources = (wf.SOURCE, sa.SOURCE, fa.SOURCE, ss.SOURCE, mg.SOURCE)
    for src, (_, secs, log) in zip(sources, _build.build(*sources)):
        print(f"[build] {src.name} built in {secs:.1f} s", flush=True)
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[build] {line.strip()}", flush=True)
    t = _phase_done("build (five kernels, in parallel)", t)
    # full fp32 products and convolutions wherever the card is held to a
    # plain or CPU result (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("[device] TF32 off: torch.backends.cuda.matmul.allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32}, torch.backends.cudnn."
          f"allow_tf32 = {torch.backends.cudnn.allow_tf32}", flush=True)
    if args.only is not None:
        if args.only == "sage":
            sage, sage_launches, t = phase_sage_all(sa, wf, t)
            entries = [_sage_entry(sage, sage_launches)]
        elif args.only == "lm_serve":
            flash, flash_launches, t = phase_lm_serve(fa, t)
            entries = [_flash_entry(flash, flash_launches)]
        elif args.only == "mamba_serve":
            entry, t = phase_mamba_serve(ss, fa, mg, t)
            entries = [entry]
        elif args.only == "kimi_serve":
            launches, _, t = phase_kimi_serve(mg, fa, t)
            print(json.dumps({"kimi_launches": launches}))
            print(f"[done] {time.perf_counter() - t_start:.1f} s ({args.only} only)")
            return 0
        else:
            entry, _, _, t = phase_moe_serve(mg, fa, t)
            entries = [entry]
        print(json.dumps({"kernels": entries}))
        print(f"[done] {time.perf_counter() - t_start:.1f} s ({args.only} only)")
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

    sage, sage_launches, t = phase_sage_all(sa, wf, t)

    flash, flash_launches, t = phase_lm_serve(fa, t)
    ssd_entry, t = phase_mamba_serve(ss, fa, mg, t)
    moe_entry, moe_flash_launches, moe_flash_err, t = phase_moe_serve(mg, fa, t)
    kimi_launches, kimi_flash_err, t = phase_kimi_serve(mg, fa, t)
    flash["max_abs_err"] = max(flash["max_abs_err"], moe_flash_err, kimi_flash_err)
    moe_entry["launches"] += kimi_launches["moe_gemm"]

    line = {
        "kernels": [
            _entry("waterfill_fill", "waterfill", "src/repro/kernels/waterfill.py:64",
                   kern, launches + sage_launches["waterfill_fill"]),
            _sage_entry(sage, sage_launches),
            _flash_entry(flash, flash_launches + moe_flash_launches
                         + kimi_launches["flash_attention"]),
            ssd_entry,
            moe_entry,
        ]
    }
    print(f"[launches] planning path: waterfill_fill {launches}; GraphSAGE "
          f"path: {sage_launches}; LM serving path: flash_attention "
          f"{flash_launches}; mamba2 path: ssd_scan {ssd_entry['launches']}; "
          f"MoE path: moe_gemm {moe_entry['launches'] - kimi_launches['moe_gemm']}, "
          f"flash_attention {moe_flash_launches}; kimi path: {kimi_launches}", flush=True)
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
