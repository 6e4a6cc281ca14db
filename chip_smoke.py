#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py        # on a machine with one CUDA card

Drives the port's main path on the card, DGTP planning, and holds it
against the port's own CPU path and against the plain version of every
kernel.  Phases, in order; any failure ends the run with a non-zero exit:

  1. build the waterfill kernel from ``src/repro_torch/kernels/csrc`` with
     nvcc for sm_90a;
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
     launches per iteration, the top device rows), the kernel table's
     JSON line, the card's name and power limit, and the closing status
     line.

Phases 3 and 4 are the main path: the kernel launch counts are set to 0
just before phase 3 and read just after phase 4.  Imports nothing of JAX
or of the ``repro`` package.
"""
from __future__ import annotations

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
# H100 SXM data sheet: HBM3 bandwidth and the fp64 (non-tensor) peak
HBM_BYTES_PER_S = 3.35e12
FP64_FLOP_PER_S = 34e12


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import waterfill as wf

    t_start = time.perf_counter()
    print(f"[device] {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    _, secs, log = wf.build()
    print(f"[build] waterfill.cu built in {secs:.1f} s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"[build] {line.strip()}", flush=True)

    kern = phase_kernel(wf)

    # the main path: counts set to 0 here, read after the plan phase
    wf.waterfill_fill.launches = 0
    with ProcessPoolExecutor(CPU_WORKERS, mp_context=get_context("spawn")) as pool:
        cands, pending, gpu = phase_engine(wf, pool)
        phase_plan(wf)
        launches = wf.waterfill_fill.launches
        check_engine(pending, gpu)
    if launches == 0:
        raise AssertionError("the main path never launched the waterfill kernel")
    phase_profile(cands)

    line = {
        "kernels": [
            {
                "name": "waterfill_fill",
                "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/waterfill.cu",
                "replaces": "src/repro/kernels/waterfill.py:64",
                "launches": launches,
                "max_abs_err": kern["max_abs_err"],
                "ms": kern["ms"],
                "plain_ms": kern["plain_ms"],
                "bound_ms": kern["bound_ms"],
                "bound_by": kern["bound_by"],
                "library_ms": None,
            }
        ]
    }
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
