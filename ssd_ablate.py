#!/usr/bin/env python3
"""Where the bf16 SSD scan backward spends its time, on the card.

    python3 ssd_ablate.py [--out chiprun_out/ssd_ablate.json]

Builds variants of the "wgmma" route of
``src/repro_torch/kernels/csrc/ssd_scan_bwd.cu`` with a part cut, each
into its own library (sources under ``build/ssd_ablate/``), and runs each
through the ``ssd_scan`` backward at mamba2-1.3b's training shape (x [4,
2048, 64, 64] bf16, d_state 128, chunk 256, one group; mamba2's A =
-linspace(1, 16, H)):

  * ``kernel``: the kernels as they are (also held to the plain backward);
  * ``scan_no_store``: the scan writes no state (neither h_c nor G_c, in
    fp32 or bf16);
  * ``scan_no_gh``: the scan's reverse sweep reads no h_c for
    sum(G_c * h_c);
  * ``tiles_no_exp``: the tile kernels' decay is 1 or 0 (no exp);
  * ``tiles_no_dBdC``: no dB += V^T C_i and dC += V B_j products;
  * ``keys_no_carry``: no G_c B_j and x G_c products in the key kernel;
  * ``keys_no_dx``: the key kernel writes no dx.

For each: the whole backward's device time per call with the L2 flushed
(``chip_smoke._device_ms``, 10 calls) and each kernel's device time per
call with the L2 warm (``chip_smoke._traced``, 8 calls in one trace).
The cut variants compute wrong gradients on purpose; only their times
count.  Variants run in the order given, then in reverse.  Imports
nothing of JAX or of the ``repro`` package.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
from pathlib import Path

from chip_smoke import _device_ms, _device_us, _traced  # also puts src/ on sys.path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "build" / "ssd_ablate"
CALLS = 8

# (old, new) replacements a variant makes; each old text occurs once
CUTS = {
    "kernel": [],
    "scan_no_store": [
        ("        hp[0] = u;\n        hp[1] = v;\n", ""),
        ("      *reinterpret_cast<uint4*>(b16 + row * DS + col) =\n"
         "          make_uint4(sm90::pack_bf16(u.x, u.y), sm90::pack_bf16(u.z, u.w),\n"
         "                     sm90::pack_bf16(v.x, v.y), sm90::pack_bf16(v.z, v.w));\n", "")],
    "scan_no_gh": [("      if (rev) {\n        const float4 hu = hp[0], hv = hp[1];",
                    "      if (u.x == 12345.f) {\n        const float4 hu = hp[0], hv = hp[1];")],
    "tiles_no_exp": [
        ("ok ? ex2(((u & 1 ? si.y : si.x) - (lo ? sja : sjb)) * kLog2e) : 0.f", "ok ? 1.f : 0.f"),
        ("ok ? ex2(((lo ? sia : sib) - (u & 1 ? sj.y : sj.x)) * kLog2e) : 0.f", "ok ? 1.f : 0.f")],
    "tiles_no_dBdC": [("      accumulate<DS>(dB, va, sC + k2 * T);", ""),
                      ("      accumulate<DS>(dC, va, sB + k2 * T);", "")],
    "keys_no_carry": [("    scores<DS>(gb, sB, sG);", ""),
                      ("    accumulate<DS>(dB, xf, sG);", "")],
    "keys_no_dx": [("      *reinterpret_cast<uint4*>(DX + o) =", "      if (o < 0) *reinterpret_cast<uint4*>(DX + o) =")],
}


def variants(src: str) -> dict:
    out = {}
    for name, cuts in CUTS.items():
        text = src
        for old, new in cuts:
            if text.count(old) != 1:
                raise ValueError(f"variant {name}: the text to cut occurs {text.count(old)} times")
            text = text.replace(old, new)
        out[name] = text
    return out


def main() -> int:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd_scan as ss

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chiprun_out/ssd_ablate.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ssd_ablate: no CUDA card")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    for header in ss.BWD_SOURCE.parent.glob("*.cuh"):
        shutil.copy(header, OUT_DIR / header.name)
    paths = {}
    for name, text in variants(ss.BWD_SOURCE.read_text()).items():
        paths[name] = OUT_DIR / f"{name}.cu"
        paths[name].write_text(text)
    _build.build(*paths.values())  # all at once; each load below finds its library

    b, s, h, hd, ds, q = 4, 2048, 64, 64, 128, 256
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(b, s, h, hd, generator=gen, device="cuda").bfloat16()
    dt = F.softplus(torch.randn(b, s, h, generator=gen, device="cuda"))
    A = -torch.linspace(1.0, 16.0, h, device="cuda")
    Bm = torch.randn(b, s, 1, ds, generator=gen, device="cuda").bfloat16()
    Cm = torch.randn(b, s, 1, ds, generator=gen, device="cuda").bfloat16()
    dy = torch.randn(b, s, h, hd, generator=gen, device="cuda").bfloat16()
    if ss.backward_route(x.dtype, hd, ds, q) != "wgmma":
        raise AssertionError("mamba2's backward shape is not on the wgmma route")
    run = lambda: ss._launch_backward(x, dt, A, Bm, Cm, dy, q)

    source = ss.BWD_SOURCE
    ss.BWD_SOURCE, ss._BWD_LIB = paths["kernel"], None
    got = run()
    want = ss.ssd_scan_backward_plain(x, dt, A, Bm, Cm, dy, chunk=q)
    err = max(((g.float() - w.float()).abs().max() / w.float().abs().max()).item()
              for g, w in zip(got, want))
    if not err <= 2e-2:
        raise AssertionError(f"the kernels != plain: {err} of the largest gradient")
    del got, want

    names = list(paths)
    times = {n: [] for n in names}
    split = {}
    for name in names + names[::-1]:
        ss.BWD_SOURCE, ss._BWD_LIB = paths[name], None
        times[name].append(_device_ms(run, 10, flush=True))
        if name not in split:
            _, rows = _traced(lambda: [run() for _ in range(CALLS)], device_only=True)
            split[name] = {re.sub(r"\(anonymous namespace\)::", "", a.key).split("(")[0]:
                           _device_us(a) / CALLS / 1e3 for a in rows}
        print(f"[ablate] {name}: {times[name][-1]:.4f} ms (L2 flushed); L2 warm: "
              + ", ".join(f"{k} {v:.4f}" for k, v in split[name].items()), flush=True)
    ss.BWD_SOURCE, ss._BWD_LIB = source, None
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    result = {"card": card, "shape": [b, s, h, hd, ds, q], "max_rel_err": err, "ms": times,
              "split_ms": split}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
