#!/usr/bin/env python3
"""The flash decode kernels' serving outputs, saved to compare two trees.

    python3 decode_bits.py OUT.pt                 # on a machine with a CUDA card
    python3 decode_bits.py --compare A.pt B.pt    # anywhere

Runs ``flash_attention`` on the decode route (no logsumexp asked, as
serving calls it) at the serving paths' decode shapes, bf16
(``flash_decode_mma``) and fp32 (``flash_decode``), with one chunk and with
several, a window, a softcap and a row that sees no key, on inputs drawn
from fixed seeds, and saves the outputs.  Run it from two checkouts (the
``src`` beside this file is the one imported) and compare: a kernel change
that leaves serving's outputs alone gives the same bits.
"""
import argparse
import sys
from pathlib import Path

# (label, (B, H, KV, Sk, D), kwargs): internlm2's and kimi-k2's serving
# decodes at one chunk and at several, gemma2's window and softcap, a row
# with no key, zamba2's shared block over a long cache
SHAPES = [
    ("internlm2 pos 200", (8, 16, 8, 2048, 128), dict(q_offset=200)),
    ("internlm2 pos 2047", (8, 16, 8, 2048, 128), dict(q_offset=2047)),
    ("kimi pos 2047", (8, 64, 8, 2048, 112), dict(q_offset=2047)),
    ("gemma2 window softcap", (8, 32, 16, 8192, 128),
     dict(q_offset=6143, window=4096, softcap=50.0)),
    ("no key", (1, 8, 2, 600, 128), dict(q_offset=700, window=4)),
    ("zamba2 long", (1, 32, 32, 65536, 112), dict(q_offset=65535)),
]


def run(out):
    import torch

    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        raise SystemExit("decode_bits: no CUDA card")
    res = {}
    for seed, (label, (b, h, kv, sk, d), kw) in enumerate(SHAPES):
        for dtype in (torch.bfloat16, torch.float32):
            gen = torch.Generator(device="cuda").manual_seed(seed)
            q = torch.randn(b, 1, h, d, generator=gen, device="cuda").to(dtype)
            k, v = (torch.randn(b, sk, kv, d, generator=gen, device="cuda").to(dtype)
                    for _ in range(2))
            o = fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                   causal=True, **kw)
            res[f"{label} {dtype}"] = o.cpu()
    if fa.flash_attention.launches_by_route["decode"] != len(res):
        raise SystemExit("decode_bits: a call did not take the decode route")
    torch.save(res, out)
    print(f"decode_bits: {len(res)} decode outputs saved to {out}")


def compare(a, b):
    import torch

    ra, rb = torch.load(a), torch.load(b)
    if sorted(ra) != sorted(rb):
        raise SystemExit(f"decode_bits: {a} and {b} hold other shapes")
    differ = [n for n in ra if not torch.equal(ra[n], rb[n])]
    for n in differ:
        print(f"decode_bits: {n}: max diff {(ra[n].float() - rb[n].float()).abs().max().item()}")
    print(f"decode_bits: {len(ra) - len(differ)} of {len(ra)} outputs the same bits")
    return 1 if differ else 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", nargs="?")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"))
    args = ap.parse_args()
    if args.compare:
        sys.exit(compare(*args.compare))
    if not args.out:
        ap.error("give OUT.pt or --compare A B")
    run(args.out)
