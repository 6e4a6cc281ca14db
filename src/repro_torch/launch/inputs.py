"""Training inputs: the shapes of one batch and concrete random batches.

The port of the JAX package's ``repro.launch.inputs`` for one device:
``train_shapes`` gives the same names, shapes and dtypes as the
reference's, and ``train_batch`` draws a batch of them from a
``torch.Generator``.  The reference's ``ShapeDtypeStruct`` and
``PartitionSpec`` helpers serve its dry-run and mesh, which wait for
ROADMAP Queue 1 item 14.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..core.engine import DeviceLike, resolve_device
from ..models.config import LMConfig


def train_shapes(cfg: LMConfig, batch: int, seq: int) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """name -> (shape, dtype) of one training batch: ``frames`` [B, S, d]
    bf16 and ``labels`` for a frames model; ``tokens`` [B, S - P],
    ``patches`` [B, P, d] bf16 and ``labels`` [B, S - P] for a patches
    model (P its ``n_patches``); else ``tokens`` and ``labels`` [B, S]
    (ids int32)."""
    if cfg.frontend == "frames":
        return {
            "frames": ((batch, seq, cfg.d_model), torch.bfloat16),
            "labels": ((batch, seq), torch.int32),
        }
    if cfg.frontend == "patches":
        text = seq - cfg.n_patches
        if text <= 0:
            raise ValueError(f"seq {seq} <= patch prefix {cfg.n_patches}")
        return {
            "tokens": ((batch, text), torch.int32),
            "patches": ((batch, cfg.n_patches, cfg.d_model), torch.bfloat16),
            "labels": ((batch, text), torch.int32),
        }
    return {
        "tokens": ((batch, seq), torch.int32),
        "labels": ((batch, seq), torch.int32),
    }


def train_batch(cfg: LMConfig, batch: int, seq: int, generator: torch.Generator, *,
                device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """A concrete random batch of ``train_shapes`` on ``device`` (default
    the card; ``generator`` lives there): ids uniform in [0, vocab),
    embeddings normal at scale 0.02 in their dtype."""
    dev = resolve_device(device)
    out: Dict[str, torch.Tensor] = {}
    for name, (shape, dt) in train_shapes(cfg, batch, seq).items():
        if name in ("labels", "tokens"):
            out[name] = torch.randint(0, cfg.vocab, shape, generator=generator,
                                      dtype=torch.int64, device=dev).to(dt)
        else:
            out[name] = (torch.randn(shape, generator=generator, device=dev)
                         * 0.02).to(dt)
    return out
