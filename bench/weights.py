"""The model's weights, drawn from the seed by the benchmark.

One generator on the device, seeded from ``--seed``; the normal leaves
are drawn in a few large fp32 calls (at most ``DRAW_ELEMENTS`` each, in
the order of ``reference.common.leaves``), scaled and cast to the dtype
they are served in.  The same seed gives the same bits, so the program's
weights and the reference's are the same tensors, drawn twice.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping

import torch

from .reference.common import leaves

DRAW_ELEMENTS = 1 << 28


def draw(cfg: Mapping[str, Any], seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    model_dtype = getattr(torch, cfg["dtype"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    specs = leaves(cfg)
    out: Dict[str, torch.Tensor] = {}
    pending, size = [], 0

    def flush() -> None:
        nonlocal pending, size
        if not pending:
            return
        z = torch.randn(size, generator=gen, dtype=torch.float32, device=device)
        at = 0
        for leaf in pending:
            n = math.prod(leaf.shape)
            part = z[at:at + n].view(leaf.shape).mul_(leaf.init[1])
            out[leaf.name] = part.to(model_dtype if leaf.dtype == "model" else torch.float32)
            at += n
        del z
        pending, size = [], 0

    for leaf in specs:
        kind = leaf.init[0]
        dt = model_dtype if leaf.dtype == "model" else torch.float32
        if kind == "normal":
            n = math.prod(leaf.shape)
            if size and size + n > DRAW_ELEMENTS:
                flush()
            pending.append(leaf)
            size += n
        elif kind == "const":
            out[leaf.name] = torch.full(leaf.shape, float(leaf.init[1]), dtype=dt, device=device)
        elif kind == "log_linspace":
            out[leaf.name] = torch.log(torch.linspace(leaf.init[1], leaf.init[2], leaf.shape[0],
                                                      dtype=torch.float32, device=device)).to(dt)
        else:
            raise ValueError(f"{leaf.name}: unknown init {leaf.init!r}")
    flush()
    return {l.name: out[l.name] for l in specs}
