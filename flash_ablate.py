#!/usr/bin/env python3
"""Where the bf16 attention kernels spend their time, on the card.

    python3 flash_ablate.py [--out chiprun_out/flash_ablate.json]

Builds variants of ``flash_wgmma`` and ``flash_decode_mma``
(``src/repro_torch/kernels/csrc/flash_attention.cu``) with a part cut or
changed, each into its own library under ``build/flash_ablate/``, and
times each through the ``flash_attention`` wrapper.  The prefill
variants, at internlm2-1.8b's prefill shape (q [4, 16, 2048, 128] over 8
KV heads, causal, bf16, L2 flushed before each call):

  * ``kernel``: the kernel as it is (also held to the plain version);
  * ``branch_per_score``: the softmax's scaling and masking tested per
    score inside its loops (``if`` on softcap and on the tile's edge);
  * ``no_softmax``: P is S packed to bf16, no max, exp or rescale;
  * ``no_products``: no wgmma (the loads, barriers and softmax alone);
  * ``two_warpgroups``, ``two_stages``: 128 query rows a block, or two
    K/V stages in place of four.

The decode variants, at its decode shape (q [8, 16, 1, 128] at position
2047 of a [8, 2048, 8, 128] cache), with the L2 flushed before each call
and without, beside ``F.scaled_dot_product_attention``:

  * ``decode``: the kernel as it is, with the wrapper's chunks and with
    chunks of 256 keys (twice as many blocks);
  * ``decode_no_evict_first``: the K and V loads without the evict-first
    L2 policy;
  * ``decode_two_stages``: two K/V tiles in flight a warp, not three.

The cut variants compute wrong outputs on purpose; only their times
count.  Variants run in the order given, then in reverse.  Imports
nothing of JAX or of the ``repro`` package.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
from pathlib import Path

from chip_smoke import (  # also puts src/ on sys.path
    LM_PREFILL, LM_SLOTS, LM_SMAX, _device_ms, _flash_qkv)

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "build" / "flash_ablate"

SOFTMAX_BRANCH_FREE = '''    if (a.softcap > 0.0f) {
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = cap(a, sc[i]) * kLog2e;
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] *= scale2;
    }
    if (edge) {
      const bool causal = a.causal != 0, windowed = a.window > 0;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int kp = k0 + 8 * (i / 4) + c2 + i % 2;
        const int qp = qmin + r0 + 8 * ((i / 2) % 2);
        const bool valid = (!causal | (kp <= qp)) & (!windowed | (kp > qp - a.window));
        // a key past Sk (zeros from TMA) is no key: -inf gives it weight 0
        sc[i] = kp >= a.Sk ? -INFINITY : valid ? sc[i] : kMasked;
      }
    }
'''
SOFTMAX_BRANCH_PER_SCORE = '''#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = a.softcap > 0.0f ? cap(a, sc[i]) * kLog2e : sc[i] * scale2;
      if (edge) {
        const int kp = k0 + 8 * (i / 4) + c2 + i % 2;
        const int qp = qmin + r0 + 8 * ((i / 2) % 2);
        x = kp >= a.Sk ? -INFINITY : key_valid(a, qp, kp) ? x : kMasked;
      }
      sc[i] = x;
    }
'''
PACK_ONLY = '''    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        pa[kk][q] = sm90::pack_bf16(sc[8 * kk + 2 * q], sc[8 * kk + 2 * q + 1]);
'''
KEEP_P = "    o[0] += __uint_as_float(pa[0][0]) * 0.0f;\n"


def _swap(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise ValueError(f"the kernel source no longer holds: {old[:60]!r}")
    return text.replace(old, new)


def _span(text: str, start: str, end: str) -> str:
    """The text from the line that starts with ``start`` to ``end``."""
    a = text.index(start)
    return text[a:text.index(end, a)]


def variants(src: str) -> dict:
    scores = _span(src, "    sm90::fence_regs(sc);\n    sm90::wgmma_fence();",
                   "    // scores in the log2 domain")
    softmax = _span(src, "    // scores in the log2 domain", "    // O += P V")
    pv = _span(src, "    // O += P V", "    sm90::mbar_arrive(&empty[s]);\n  }")
    return {
        "kernel": src,
        "branch_per_score": _swap(src, SOFTMAX_BRANCH_FREE, SOFTMAX_BRANCH_PER_SCORE),
        "no_softmax": _swap(src, softmax, PACK_ONLY),
        "no_products": _swap(_swap(src, scores, ""), pv, KEEP_P),
        "two_warpgroups": _swap(src, "constexpr int kWGroups = 3;", "constexpr int kWGroups = 2;"),
        "two_stages": _swap(src, "constexpr int kWStages = 4;", "constexpr int kWStages = 2;"),
        "decode_no_evict_first": _swap(_swap(
            src, "sm90::cp_async16_hint(sK + r * L::kPitch + 8 * pc, K + row * a.k_ss + 8 * pc, "
                 "n, policy);",
            "sm90::cp_async16(sK + r * L::kPitch + 8 * pc, K + row * a.k_ss + 8 * pc, n);"),
            "sm90::cp_async16_hint(sV + r * L::kPitch + 8 * pc, Vg + row * a.v_ss + 8 * pc, "
            "n, policy);",
            "sm90::cp_async16(sV + r * L::kPitch + 8 * pc, Vg + row * a.v_ss + 8 * pc, n);"),
        "decode_two_stages": _swap(src, "constexpr int kMmaStages = 3; ",
                                   "constexpr int kMmaStages = 2; "),
    }


def _decode_times(fa, libs, torch):
    """The decode variants' ms (L2 flushed, then not) at internlm2-1.8b's
    decode shape at position 2047, in the order given and then reversed,
    beside SDPA's; each variant held to the plain version first."""
    import torch.nn.functional as F

    pos = LM_SMAX - 1
    q, k, v = _flash_qkv(8, LM_SLOTS, 16, 8, 1, LM_SMAX, 128, torch.bfloat16)
    want = fa.flash_attention_plain(q, k, v, q_offset=pos)
    plan = fa.decode_plan
    runs = {
        "decode": (libs["kernel"], plan),
        "decode_chunks_of_256": (libs["kernel"],
                                 lambda *a: (0, pos, 256, -(-(pos + 1) // 256))),
        "decode_no_evict_first": (libs["decode_no_evict_first"], plan),
        "decode_two_stages": (libs["decode_two_stages"], plan),
        "sdpa": (None, plan),
    }
    out = {name: {"flushed": [], "not_flushed": []} for name in runs}
    for name in list(runs) + list(reversed(runs)):
        lib, fa.decode_plan = runs[name]
        if lib is None:
            fn = lambda: F.scaled_dot_product_attention(q, k, v, enable_gqa=True)
        else:
            fa._LIB = lib
            fn = lambda: fa.flash_attention(q, k, v, q_offset=pos)
            err = (fn().float() - want.float()).abs().max().item()
            if not err <= 2e-2:
                raise AssertionError(f"{name} != plain: {err}")
        out[name]["flushed"].append(_device_ms(fn, 50, flush=True))
        out[name]["not_flushed"].append(_device_ms(fn, 50))
        print(f"[ablate] {name}: {out[name]['flushed'][-1]:.4f} ms flushed, "
              f"{out[name]['not_flushed'][-1]:.4f} ms not", flush=True)
    fa.decode_plan = plan
    return out


def main() -> int:
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chiprun_out/flash_ablate.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("flash_ablate: no CUDA card")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    for header in fa.SOURCE.parent.glob("*.cuh"):
        shutil.copy(header, OUT_DIR / header.name)
    paths = []
    for name, text in variants(fa.SOURCE.read_text()).items():
        path = OUT_DIR / f"{name}.cu"
        path.write_text(text)
        paths.append(path)
    libs = {p.stem: fa.load(lib) for p, (lib, _, _) in zip(paths, _build.build(*paths))}

    B, S = LM_PREFILL
    q, k, v = _flash_qkv(7, B, 16, 8, S, S, 128, torch.bfloat16)
    fa._LIB = libs["kernel"]
    err = (fa.flash_attention(q, k, v).float()
           - fa.flash_attention_plain(q, k, v).float()).abs().max().item()
    if not err <= 2e-2:
        raise AssertionError(f"the kernel != plain: {err}")
    prefill = [n for n in libs if not n.startswith("decode")]
    times = {name: [] for name in prefill}
    for name in prefill + list(reversed(prefill)):
        fa._LIB = libs[name]
        times[name].append(_device_ms(lambda: fa.flash_attention(q, k, v), 20, flush=True))
        print(f"[ablate] {name}: {times[name][-1]:.4f} ms", flush=True)
    decode = _decode_times(fa, libs, torch)
    fa._LIB = None
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    result = {"card": card, "shape": [B, 16, 8, S, 128], "max_abs_err": err, "ms": times,
              "decode": decode}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
