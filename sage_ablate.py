#!/usr/bin/env python3
"""Where the GraphSAGE aggregation kernels spend their time, on the card.

    python3 sage_ablate.py [--out chiprun_out/sage_ablate.json]

At the three aggregations of one ogbn-products batch (``chip_smoke.py``'s
phase 6: its graph, sampler and shapes, fp32), with the L2 flushed before
each call and without, times:

  * the forward (``csrc/sage_aggregate.cu``) and variants of it, each
    built from an edited copy of the source into its own library and
    first held to the plain version bit for bit: ``no_prefetch`` (the
    next ids fetched after the adds), ``ids16`` (16 rows' loads in flight
    a thread, not 8), ``min3`` (registers capped for three blocks an SM),
    ``volatile_loads`` (loads the compiler may not schedule together),
    ``l2_policies`` (x read evict-last and the output stored
    evict-first in L2; the flush does not evict evict-last lines, so its
    flushed times flatter it); ``probe`` (the loads alone) through the
    wrapper;
  * the forward with its rows gathered by Hopper's asynchronous copies
    (``csrc/sage_gather_probes.cu``, compiled appended to a copy of the
    kernel's source), whole (held to the plain version bit for bit) and
    the copies alone: 1-D TMA bulk copies into a ring of S stages of R
    rows (as many blocks an SM as their shared memory lets), and
    cp.async copies into per-thread rings of S stages on the forward's
    tiles and thread map;
  * the backward's parts one by one (``prep`` with the counts' memset,
    the scan ``torch.cumsum``, ``fill`` with a copy of the counts,
    ``long``, ``sum``), beside the whole backward and ``index_add_``;
    two variants of ``sum``: ``sum_u8`` (8 positions' rows in flight
    a warp, not 4) and ``sum_guarded`` (no loads past the segment's
    end); and ``long``'s sort alone and its sum alone; at each layer and
    on layer 1's ids with three hubs;
  * the L2 policies in a training step: the device time of the three
    forward launches of a GraphSAGE step (forward and backward on one
    batch, under ``torch.profiler``), with the kernel and with
    ``l2_policies``.

Variants run in the order given, then in reverse; each time printed is
the mean of the two passes.  Imports nothing of JAX or of the ``repro``
package.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np

from chip_smoke import (  # also puts src/ on sys.path
    SAGE_BATCH, SAGE_FANOUTS, SAGE_NODES, _device_ms, _device_us, _sage_x)

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT_DIR = ROOT / "build" / "sage_ablate"
# the bulk probe's ring shapes: (rows a tile, stages, shared-memory budget
# of a block: 220 KB for one block an SM, 110 for two, 72 for three)
BULK_RINGS = [(1, 16, 220), (10, 16, 220), (4, 16, 72)]
BULK_CHUNK = 1024
# the whole bulk forward's shared-memory budgets (its tile is the
# register kernel's: as many rows as 256 threads of 16 bytes cover)
BULK_MEAN_BUDGETS = (220, 110, 72)
# the cp.async rings' stages (their template cases) and shared memory
ASYNC_STAGES = (2, 3, 5, 8)
ASYNC_BUDGET = 220 * 1024
STEP_REPS = 10  # profiled training steps a library and pass


def _ok(err: int) -> None:
    if err != 0:
        raise RuntimeError(f"probe launch failed: CUDA error {err}")


def _swap(text: str, old: str, new: str) -> str:
    if old not in text:
        raise AssertionError(f"variant anchor not found: {old[:60]!r}")
    return text.replace(old, new)


# the forward's load and store, and the same under L2 policies (x
# evict-last, the output evict-first)
_LOAD = '''  const Wd w = __ldg(reinterpret_cast<const Wd*>(p));
'''
_LOAD_HINT = '''  Wd w;
  uint64_t pol;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\\n" : "=l"(pol));
  if constexpr (sizeof(Wd) == 16) {
    asm("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;\\n"
        : "=r"(w.x), "=r"(w.y), "=r"(w.z), "=r"(w.w) : "l"(p), "l"(pol));
  } else if constexpr (sizeof(Wd) == 8) {
    asm("ld.global.nc.L2::cache_hint.v2.u32 {%0, %1}, [%2], %3;\\n"
        : "=r"(w.x), "=r"(w.y) : "l"(p), "l"(pol));
  } else if constexpr (sizeof(Wd) == 4) {
    asm("ld.global.nc.L2::cache_hint.u32 %0, [%1], %2;\\n" : "=r"(w) : "l"(p), "l"(pol));
  } else {
    asm("ld.global.nc.L2::cache_hint.u16 %0, [%1], %2;\\n" : "=h"(w) : "l"(p), "l"(pol));
  }
'''
_STORE = '''  *reinterpret_cast<Pack<T, VEC>*>(p) = q;
'''
_STORE_HINT = '''  using Wd = typename Word<sizeof(T) * VEC>::type;
  Wd w;
  memcpy(&w, &q, sizeof(w));
  uint64_t pol;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\\n" : "=l"(pol));
  if constexpr (sizeof(Wd) == 16) {
    asm volatile("st.global.L2::cache_hint.v4.u32 [%0], {%1, %2, %3, %4}, %5;\\n"
                 :: "l"(p), "r"(w.x), "r"(w.y), "r"(w.z), "r"(w.w), "l"(pol) : "memory");
  } else if constexpr (sizeof(Wd) == 8) {
    asm volatile("st.global.L2::cache_hint.v2.u32 [%0], {%1, %2}, %3;\\n"
                 :: "l"(p), "r"(w.x), "r"(w.y), "l"(pol) : "memory");
  } else if constexpr (sizeof(Wd) == 4) {
    asm volatile("st.global.L2::cache_hint.u32 [%0], %1, %2;\\n"
                 :: "l"(p), "r"(w), "l"(pol) : "memory");
  } else {
    asm volatile("st.global.L2::cache_hint.u16 [%0], %1, %2;\\n"
                 :: "l"(p), "h"(w), "l"(pol) : "memory");
  }
'''


def variants(src: str) -> dict:
    """name -> edited source of the kernels' variants."""
    load_next = '''      const bool more = j0 + kIds < K;
      load_ids(id, idx, more ? m : tiles.row0(t + gridDim.x, R) + r, M, K,
               more ? j0 + kIds : 0);
'''
    adds_end = '''      if (!more) break;
'''
    moved = _swap(src, load_next, "      const bool more = j0 + kIds < K;\n")
    moved = _swap(moved, adds_end, load_next.replace("      const bool more = j0 + kIds < K;\n", "")
                  + adds_end)
    fwd_bounds = '''__global__ void __launch_bounds__(kThreads)
    sage_fwd('''
    sum_load = '''            val[u][h] = *reinterpret_cast<const Pack<float, VEC>*>('''
    long_call = '''        sort_rows(seg, len, K, MK, bits, warp_sums);
'''
    return {
        "kernel": src,
        "no_prefetch": moved,
        "ids16": _swap(src, "constexpr int kIds = 8;", "constexpr int kIds = 16;"),
        "min3": _swap(src, fwd_bounds, fwd_bounds.replace("(kThreads)", "(kThreads, 3)")),
        "l2_policies": _swap(_swap(src, _LOAD, _LOAD_HINT), _STORE, _STORE_HINT),
        "sum_u8": _swap(src, "  constexpr int U = 4;\n  constexpr int W = 64 * VEC;",
                        "  constexpr int U = 8;\n  constexpr int W = 64 * VEC;"),
        "sum_guarded": _swap(src, sum_load, "            if (u0 + u < n)\n" + sum_load),
        "long_sort_only": _swap(src, long_call, long_call + "        if (len > 0) continue;\n"),
        "long_sum_only": _swap(src, long_call, '''        for (int k = threadIdx.x; k < len; k += kThreads) seg[k] /= K;
        __syncthreads();
'''),
        "routes": src + "\n" + (CSRC / "sage_gather_probes.cu").read_text(),
    }


def build_variants():
    """Each variant's source beside a copy of the headers, all built at once."""
    if OUT_DIR.exists():
        shutil.rmtree(OUT_DIR)
    OUT_DIR.mkdir(parents=True)
    for header in CSRC.glob("*.cuh"):
        shutil.copy(header, OUT_DIR / header.name)
    paths = {}
    for name, text in variants((CSRC / "sage_aggregate.cu").read_text()).items():
        paths[name] = OUT_DIR / f"sage_{name}.cu"
        paths[name].write_text(text)
    from repro_torch.kernels import _build

    built = _build.build(*paths.values())
    for (name, _), (lib, secs, log) in zip(paths.items(), built):
        print(f"[build] {name} in {secs:.1f} s", flush=True)
        for line in log.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()[:160]}", flush=True)
    return {name: lib for name, (lib, _, _) in zip(paths, built)}


def _forward_lib(sa, path):
    """A variant library with the wrapper's C signatures."""
    saved, build = sa._LIB, sa.build
    sa._LIB, sa.build = None, lambda: (path, 0.0, "")
    try:
        return sa._library()
    finally:
        sa._LIB, sa.build = saved, build


def _bulk_smem(R, K, S, chunk):
    return 128 + -(-S * R * K * 4 // 128) * 128 + S * R * K * chunk


def _backward_parts(sa, libs, label, idx, N, F, gen):
    """The backward's parts and variants on ids idx [M, K] of rows of F
    values (N of them), each timed with the L2 flushed and hot."""
    import torch

    M, K = idx.shape
    stream = torch.cuda.current_stream().cuda_stream
    go = torch.randn(M, F, device="cuda", generator=gen)
    lib = sa._library()
    count = torch.zeros(N, dtype=torch.int32, device="cuda")
    gs = torch.empty((M, F), device="cuda")
    pos = torch.empty(M * K, dtype=torch.int32, device="cuda")
    gx = torch.empty((N, F), device="cuda")
    _ok(lib.repro_sage_bwd_prep(go.data_ptr(), idx.data_ptr(), count.data_ptr(),
                                gs.data_ptr(), M, K, F, 4, stream))
    saved = count.clone()
    incl = torch.cumsum(saved, 0, dtype=torch.int32)
    flat = idx.reshape(-1).long()
    keep = torch.nonzero(flat >= 0).squeeze(1)
    add_ids, add_rows = flat[keep], gs[keep // K]
    add_buf = torch.zeros(N, F, device="cuda")

    def fill():
        count.copy_(saved)
        _ok(lib.repro_sage_bwd_fill(idx.data_ptr(), incl.data_ptr(), count.data_ptr(),
                                    pos.data_ptr(), M * K, stream))

    fill()

    D, bitmap = sa.long_plan(F, M * K)

    def long_part(name):  # the fill first: long leaves rows, not positions, in pos
        def run():
            fill()
            _ok(libs[name].repro_sage_bwd_long(
                gs.data_ptr(), incl.data_ptr(), pos.data_ptr(), gx.data_ptr(), N, F, K, M * K,
                D, int(bitmap), 4, stream))
        return run

    parts = {
        "backward": lambda: sa.sage_aggregate_backward(go, idx, N),
        "index_add_": lambda: add_buf.index_add_(0, add_ids, add_rows),
        "prep (with the counts' memset)": lambda: _ok(lib.repro_sage_bwd_prep(
            go.data_ptr(), idx.data_ptr(), count.zero_().data_ptr(), gs.data_ptr(),
            M, K, F, 4, stream)),
        "scan (torch.cumsum)": lambda: torch.cumsum(saved, 0, dtype=torch.int32),
        "fill (with a copy of the counts)": fill,
        "long (segments past 32 positions), after a fill": long_part("kernel"),
        "long's sort alone, after a fill": long_part("long_sort_only"),
        "long's sum alone (unsorted), after a fill": long_part("long_sum_only"),
    }
    for name in ("kernel", "sum_u8", "sum_guarded"):
        def part(lib=libs[name]):
            _ok(lib.repro_sage_bwd_sum(gs.data_ptr(), incl.data_ptr(), pos.data_ptr(),
                                       gx.data_ptr(), N, F, K, 4, stream))
        parts["sum" if name == "kernel" else name] = part
    parts["sum"]()
    want_gx = gx.clone()
    for name in ("sum_u8", "sum_guarded"):
        parts[name]()
        if not torch.equal(gx, want_gx):
            raise AssertionError(f"{label} {name}: differs from the kernel's sum")
    rows = {}
    for name, fn in parts.items():
        rows[name] = {"flushed_ms": _device_ms(fn, 20, flush=True),
                      "hot_ms": _device_ms(fn, 50)}
        print(f"[backward] {label} {name}: flushed {rows[name]['flushed_ms']:.4f} "
              f"ms, hot {rows[name]['hot_ms']:.4f} ms", flush=True)
    return rows


def _step_fwd_ms(sa, lib, model, batch, sage_loss):
    """Device ms of the forward launches (sage_fwd) and of every kernel in
    one training step's forward and backward, with the forward's library
    ``lib``: the mean of STEP_REPS profiled steps after a warm-up step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    saved, sa._LIB = sa._LIB, lib
    try:
        with profile(activities=[ProfilerActivity.CUDA], acc_events=True,
                     schedule=schedule(wait=0, warmup=1, active=STEP_REPS)) as prof:
            for _ in range(STEP_REPS + 1):
                loss, _ = sage_loss(model, batch)
                loss.backward()
                model.zero_grad(set_to_none=True)
                torch.cuda.synchronize()
                prof.step()
    finally:
        sa._LIB = saved
    rows = [a for a in prof.key_averages() if a.device_type == DeviceType.CUDA]
    fwd = [a for a in rows if "sage_fwd<" in a.key]
    if sum(a.count for a in fwd) != 3 * STEP_REPS:
        raise AssertionError(f"the step's trace holds {sum(a.count for a in fwd)} forward "
                             f"launches, not {3 * STEP_REPS}")
    return (sum(_device_us(a) for a in fwd) / 1e3 / STEP_REPS,
            sum(_device_us(a) for a in rows) / 1e3 / STEP_REPS)


def main() -> int:
    import torch

    from repro_torch.data.graph import sample_blocks, synthetic_graph
    from repro_torch.kernels import sage_aggregate as sa
    from repro_torch.models import GraphSAGE, SageConfig, batch_to, sage_loss

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chiprun_out/sage_ablate.json")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"[device] {smi.stdout.strip()}", flush=True)
    paths = build_variants()
    libs = {name: _forward_lib(sa, path) for name, path in paths.items()}
    routes = ctypes.CDLL(str(paths["routes"]))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for fn, n_ptr, n_int in (("repro_sage_bulk_mean", 3, 7), ("repro_sage_bulk_probe", 2, 7),
                             ("repro_sage_async_mean", 3, 7), ("repro_sage_async_probe", 2, 6)):
        getattr(routes, fn).argtypes = [vp] * n_ptr + [ci] * n_int + [vp]
        getattr(routes, fn).restype = ci

    t0 = time.perf_counter()
    g = synthetic_graph(n_nodes=SAGE_NODES, n_feats=100, n_classes=47, n_parts=4, seed=0)
    rng = np.random.default_rng(0)
    seeds = rng.choice(g.train_nodes, SAGE_BATCH, replace=False)
    feats, blocks, labels, _ = sample_blocks(g, seeds, SAGE_FANOUTS, rng)
    batch = batch_to(feats, blocks, labels, device="cuda")
    print(f"[data] one batch in {time.perf_counter() - t0:.1f} s", flush=True)
    result = {"device": smi.stdout.strip(), "forward": {}, "backward": {}}
    gen = torch.Generator(device="cuda").manual_seed(1)
    with torch.no_grad():
        for label, x, idx in _sage_x(batch["feats"], batch["blocks"], 256, 0):
            N, F = x.shape
            M, K = idx.shape
            want = sa.sage_aggregate_plain(x, idx)
            stream = torch.cuda.current_stream().cuda_stream
            cases = {}
            for name, kw in (("kernel", {}), ("no_prefetch", {}), ("ids16", {}),
                             ("min3", {}), ("l2_policies", {}), ("probe", {"probe": True})):
                def run(lib=libs["kernel" if name == "probe" else name], kw=kw):
                    saved, sa._LIB = sa._LIB, lib
                    try:
                        return sa._launch(x, idx, **kw)
                    finally:
                        sa._LIB = saved
                if "probe" not in kw and not torch.equal(run(), want):
                    raise AssertionError(f"{label} {name}: differs from the plain version")
                cases[name] = run
            plan = sa.forward_plan(F, 4, x.data_ptr())
            out = torch.empty_like(want)
            chunk = min(F, 1024)
            R = sa.THREADS // (chunk // 4)
            for budget in BULK_MEAN_BUDGETS:
                S = 16
                while S > 1 and _bulk_smem(R, K, S, chunk * 4) > budget * 1024:
                    S -= 1
                smem = _bulk_smem(R, K, S, chunk * 4)

                def whole(S=S, smem=smem):
                    _ok(routes.repro_sage_bulk_mean(x.data_ptr(), idx.data_ptr(),
                                                    out.data_ptr(), M, K, F, chunk, R, S,
                                                    smem, stream))
                out.fill_(float("nan"))
                whole()
                if not torch.equal(out, want):
                    raise AssertionError(f"{label} bulk forward S={S}: differs from the "
                                         f"plain version")
                cases[f"bulk forward R={R} S={S} ({smem} B a block)"] = whole
            row_chunk = min(BULK_CHUNK, F * 4)
            for R, S, budget in BULK_RINGS:
                while S > 1 and _bulk_smem(R, K, S, row_chunk) > budget * 1024:
                    S -= 1
                smem = _bulk_smem(R, K, S, row_chunk)

                def ring(R=R, S=S, smem=smem):
                    _ok(routes.repro_sage_bulk_probe(
                        x.data_ptr(), idx.data_ptr(), M, K, F * 4, row_chunk, R, S, smem,
                        stream))
                ring()
                cases[f"bulk copies R={R} S={S} ({smem} B a block)"] = ring
            for S in ASYNC_STAGES:
                smem = S * min(K, 8) * sa.THREADS * 16 + S * sa.THREADS * 4
                if smem > ASYNC_BUDGET:
                    continue

                def whole(S=S, smem=smem):
                    _ok(routes.repro_sage_async_mean(x.data_ptr(), idx.data_ptr(),
                                                     out.data_ptr(), M, K, F, plan.W, plan.R,
                                                     S, smem, stream))
                out.fill_(float("nan"))
                whole()
                if not torch.equal(out, want):
                    raise AssertionError(f"{label} cp.async forward S={S}: differs from "
                                         f"the plain version")
                cases[f"cp.async forward S={S} ({smem} B a block)"] = whole
            for S in ASYNC_STAGES:
                smem = S * min(K, 16) * sa.THREADS * 16
                if smem > ASYNC_BUDGET:
                    continue

                def ring(S=S, smem=smem):
                    _ok(routes.repro_sage_async_probe(
                        x.data_ptr(), idx.data_ptr(), M, K, F * 4, plan.R, S, smem, stream))
                ring()
                cases[f"cp.async copies S={S} ({smem} B a block)"] = ring
            torch.cuda.synchronize()
            rows = {name: {"flushed_ms": [], "hot_ms": []} for name in cases}
            for order in (list(cases), list(reversed(cases))):
                for name in order:
                    rows[name]["flushed_ms"].append(
                        _device_ms(cases[name], 20, flush=True))
                    rows[name]["hot_ms"].append(_device_ms(cases[name], 50))
            for name, row in rows.items():
                row.update({k: float(np.mean(v)) for k, v in list(row.items())})
                print(f"[forward] {label} {name}: flushed {row['flushed_ms']:.4f} ms, hot "
                      f"{row['hot_ms']:.4f} ms", flush=True)
            result["forward"][label] = rows

            result["backward"][label] = _backward_parts(sa, libs, label, idx, N, F, gen)
        # layer 1's ids with the first of each row one of three hubs
        _, x, idx = _sage_x(batch["feats"], batch["blocks"], 256, 0)[1]
        idx = idx.clone()
        idx[:, 0] = torch.arange(idx.shape[0], device="cuda", dtype=torch.int32) % 3
        result["backward"]["layer 1, 3 hubs"] = _backward_parts(
            sa, libs, "layer 1, 3 hubs", idx, x.shape[0], x.shape[1], gen)

    # the L2 policies in a training step: kernel, policies, policies, kernel
    cfg = SageConfig(in_dim=100, hidden=256, n_classes=47, n_layers=3)
    model = GraphSAGE(cfg, device="cuda", seed=0)
    steps = {"kernel": [], "l2_policies": []}
    for name in ("kernel", "l2_policies", "l2_policies", "kernel"):
        steps[name].append(_step_fwd_ms(sa, libs[name], model, batch, sage_loss))
    result["step"] = {}
    for name, runs in steps.items():
        fwd, total = (float(np.mean(v)) for v in zip(*runs))
        result["step"][name] = {"forward_ms": fwd, "step_device_ms": total}
        print(f"[step] {name}: the three forward launches {fwd:.4f} ms of a step's "
              f"{total:.4f} ms on the device (mean of {2 * STEP_REPS} profiled steps)",
              flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
