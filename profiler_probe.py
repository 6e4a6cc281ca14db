#!/usr/bin/env python3
"""Measures what ``torch.profiler`` keeps of a short trace on the card.

    python3 profiler_probe.py [--points 5] [--every 30] [--calls 5]
                              [--out chiprun_out/profiler_probe.json]

At each of ``--points`` moments, ``--every`` seconds apart (the card kept
busy in between), this script traces ``--calls`` bf16 products of two
[4096, 4096] matrices (about 1 ms of device work) five ways: with no
idle time around them, with 20 ms and with 50 ms of idle host time traced
before and after, after 16 and after 256 spin kernels
(``torch.cuda._sleep``, as ``chip_smoke.py``'s ``_traced`` opens every
trace); and then 200 products with 50 ms around them.  For each trace it
prints the products' device rows kept, the spin kernels' rows kept and,
where rows were kept, each kernel's start on the device less its
launch's start on the host (correlated by id): normally a few
microseconds for the first kernel, then growing as the queue fills.
Rows missing from the start of a short trace show the profiler dropping
them.  Imports nothing of JAX or of the ``repro`` package.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

PADS = (0.0, 0.02, 0.05)
SPINS = (16, 256)
LONG_CALLS = 200


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--points", type=int, default=5)
    ap.add_argument("--every", type=float, default=30.0)
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profiler_probe: no CUDA card", file=sys.stderr)
        return 2
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(4096, 4096, device="cuda", dtype=torch.bfloat16)

    def work(n):
        for _ in range(n):
            x @ x

    def trace(n, pad, spins=0):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(spins):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            time.sleep(pad)
            work(n)
            torch.cuda.synchronize()
            time.sleep(pad)
        events = prof.profiler.kineto_results.events()
        launch = {}
        for e in events:
            if e.device_type() != DeviceType.CUDA and e.name().startswith("cu"):
                launch.setdefault(e.correlation_id(), e.start_ns())
        rows = [e for e in events if e.device_type() == DeviceType.CUDA]
        kernels = [e for e in rows if "spin_kernel" not in e.name()]
        offs = sorted((k.start_ns() - launch[k.correlation_id()]) / 1e3 for k in kernels
                      if k.correlation_id() in launch)
        return {"calls": n, "pad_s": pad, "spins": spins,
                "spin_rows": len(rows) - len(kernels), "launches": len(launch) - spins,
                "device_rows": len(kernels),
                "first_offset_us": offs[0] if offs else None,
                "median_offset_us": statistics.median(offs) if offs else None}

    t0 = time.perf_counter()
    work(20)
    torch.cuda.synchronize()
    print(f"[probe] {torch.cuda.get_device_name(0)}, torch {torch.__version__}", flush=True)
    points = []
    for i in range(args.points):
        if i:
            t = time.perf_counter()
            while time.perf_counter() - t < args.every:
                work(50)
                torch.cuda.synchronize()
                time.sleep(0.05)
        at = time.perf_counter() - t0
        rows = ([trace(args.calls, pad) for pad in PADS]
                + [trace(args.calls, 0.0, spins) for spins in SPINS]
                + [trace(LONG_CALLS, PADS[-1])])
        points.append({"at_s": at, "traces": rows})
        for r in rows:
            off = ("no rows" if r["first_offset_us"] is None else
                   f"first kernel {r['first_offset_us']:.1f} us after its launch, median "
                   f"{r['median_offset_us']:.1f} us")
            print(f"[probe] {at:7.1f} s: {r['calls']} products, {1e3 * r['pad_s']:.0f} ms "
                  f"idle on either side, after {r['spins']} spin kernels "
                  f"({r['spin_rows']} of their rows kept): {r['device_rows']} device rows for "
                  f"{r['launches']} launches; {off}", flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"device": torch.cuda.get_device_name(0),
                                        "points": points}, indent=1))
    labels = [f"{1e3 * pad:.0f} ms idle" for pad in PADS] + [f"{n} spins" for n in SPINS]
    print(json.dumps({"short_traces_rows_kept": {
        label: [p["traces"][j]["device_rows"] for p in points]
        for j, label in enumerate(labels)}, "points": len(points)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
