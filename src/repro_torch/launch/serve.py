"""Serving driver: batched decode with continuous batching.

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve   # internlm2-1.8b on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama4-scout-17b-a16e --layers 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-27b --layers 8

The port of ``repro.launch.serve``, with the same flags and defaults, plus
``--device`` (default: the CUDA card; it raises when there is none),
``--seed`` (the weights' generator) and ``--layers`` (cut the depth, for
any arch: the 48 layers of llama4-scout, ~202 GB in bf16, do not fit one
card).  Every arch of the reference is a choice; an encoder
(hubert-xlarge) has no decode path and exits, as in the reference.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, List, Optional

import torch

from .. import configs as cfgs
from ..models.model import TransformerLM
from ..serve.engine import Request, ServeEngine


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b",
                    choices=cfgs.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--smax", type=int, default=128)
    ap.add_argument("--max-tokens", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: cuda; raises without a card)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=None,
                    help="serve only the first this many layers (default: all)")
    args = ap.parse_args(argv)
    cfg = cfgs.get_smoke_config(args.arch) if args.smoke else cfgs.get_config(args.arch)
    if cfg.is_encoder:
        raise SystemExit("encoder-only archs have no decode path")
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    model = TransformerLM(cfg, device=args.device)
    model.init(torch.Generator(device=model.device).manual_seed(args.seed))
    engine = ServeEngine(model, n_slots=args.slots, smax=args.smax)
    for i in range(args.requests):
        engine.submit(
            Request(rid=i, prompt=[1 + i % 13, 2, 3], max_tokens=args.max_tokens)
        )
    stats = engine.run()
    print(
        f"{cfg.name} ({cfg.n_layers} layers): {stats['tokens']} tokens over "
        f"{stats['ticks']} ticks "
        f"({stats['tok_per_s']:.1f} tok/s, {args.slots} slots, {model.device})"
    )
    return stats


if __name__ == "__main__":
    main()
