"""Batched serving example on PyTorch: continuous batching over decode slots.

    python examples/serve_decode_torch.py [--requests 12] [--device cpu]

The twin of examples/serve_decode.py on the port (``repro_torch``): the
smoke config of ``--arch`` with seeded random weights, 8 slots of 128
positions, each request 16 new tokens.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models import TransformerLM
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    cfg = get_smoke_config(args.arch)
    model = TransformerLM(cfg, device=args.device)
    model.init(torch.Generator(device=model.device).manual_seed(0))
    eng = ServeEngine(model, n_slots=8, smax=128)
    for i in range(args.requests):
        eng.submit(Request(rid=i, prompt=[1 + i % 7, 2, 3, 4], max_tokens=16))
    stats = eng.run()
    print(
        f"served {args.requests} requests: {stats['tokens']} tokens in "
        f"{stats['ticks']} ticks, {stats['tok_per_s']:.1f} tok/s"
    )


if __name__ == "__main__":
    main()
