"""Gradient compression with error feedback, on PyTorch.

The port of the JAX package's ``repro.train.compression``: a transform of
the gradient tree before the optimizer (and before the all-reduce or
parameter-server flows that the DGTP planner schedules; compressed
volumes shrink d_{w->ps} in the cluster model):

  * int8 stochastic rounding with a per-leaf scale (max |g| / 127), ~4x
    less volume; the noise is uniform in [-0.5, 0.5), drawn from a
    ``torch.Generator`` (JAX's draws differ, so the tests hand its noise
    to ``_int8_compress``);
  * top-k magnitude sparsification (k a fraction of each leaf), keeping
    every entry with |g| >= the k-th largest |g|, ties included, as the
    reference's mask does;

each with the residual carried to the next step (error feedback: the
mean compressed gradient tends to the true one).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from .optimizer import Tree, tree_build, tree_items


@dataclass(frozen=True)
class CompressionSettings:
    kind: str = "int8"  # "int8" | "topk" | "none"
    topk_frac: float = 0.05


# the reference's name (see optimizer.AdamWConfig)
CompressionConfig = CompressionSettings


def init_error_state(grads_like: Tree) -> Tree:
    """Zero fp32 residuals shaped like the gradient tree."""
    return tree_build([(n, torch.zeros(g.shape, dtype=torch.float32, device=g.device))
                       for n, g in tree_items(grads_like)])


def _int8_compress(g: torch.Tensor, noise: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 codes, scale) of fp32 g with the rounding ``noise`` in [-0.5,
    0.5) added before rounding half to even."""
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale + noise), -127, 127).to(torch.int8)
    return q, scale


def _int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _topk_mask(g: torch.Tensor, frac: float) -> torch.Tensor:
    """1 where |g| >= the k-th largest |g| (k = max(1, int(size * frac))),
    else 0, in g's dtype."""
    k = max(1, int(g.numel() * frac))
    mags = g.abs().reshape(-1)
    thresh = torch.topk(mags, k, sorted=True).values[-1]
    return (g.abs() >= thresh).to(g.dtype)


def compress_grads(cfg: CompressionSettings, grads: Tree, error: Tree,
                   generator: torch.Generator) -> Tuple[Tree, Tree, Dict[str, float]]:
    """(the decompressed gradients the optimizer sees, the new residuals,
    metrics ``raw_bytes`` and ``compressed_bytes``).  Each leaf compresses
    g + its residual in fp32; int8 draws its noise from ``generator``
    (on the gradients' device), leaf by leaf in tree order."""
    items = list(tree_items(grads))
    raw = float(sum(g.numel() * 4 for _, g in items))
    if cfg.kind == "none":
        return grads, error, {"raw_bytes": raw, "compressed_bytes": raw}
    errs = dict(tree_items(error))
    out, new_err = [], []
    comp = 0.0
    for path, g in items:
        gf = g.float() + errs[path]
        if cfg.kind == "int8":
            noise = torch.rand(gf.shape, generator=generator, device=gf.device) - 0.5
            d = _int8_decompress(*_int8_compress(gf, noise))
            comp += g.numel() * 1 + 4
        elif cfg.kind == "topk":
            d = gf * _topk_mask(gf, cfg.topk_frac)
            comp += g.numel() * cfg.topk_frac * 8  # value + index
        else:
            raise ValueError(f"unknown compression {cfg.kind!r}")
        out.append((path, d))
        new_err.append((path, gf - d))
    return tree_build(out), tree_build(new_err), {"raw_bytes": raw, "compressed_bytes": comp}
