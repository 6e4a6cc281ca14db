"""Training inputs: the shapes of one batch, concrete random batches, and
stand-ins and specs for the dry run and the mesh.

The port of the JAX package's ``repro.launch.inputs``: ``train_shapes``
gives the same names, shapes and dtypes as the reference's,
``train_batch`` draws a batch of them from a ``torch.Generator``;
``train_structs`` and ``decode_inputs_structs`` are uninitialised
tensors of those shapes (meta tensors by default; fake ones when made
under ``FakeTensorMode``), the reference's ``ShapeDtypeStruct``s, and
``batch_specs`` their specs on a mesh (``sharding``'s tuples).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..core.engine import DeviceLike, resolve_device
from ..models.config import LMConfig
from ..sharding import MeshContext, Spec


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


def train_structs(cfg: LMConfig, batch: int, seq: int, *,
                  device: DeviceLike = "meta") -> Dict[str, torch.Tensor]:
    """Uninitialised tensors of ``train_shapes`` on ``device``."""
    return {k: torch.empty(shape, dtype=dt, device=device)
            for k, (shape, dt) in train_shapes(cfg, batch, seq).items()}


def batch_specs(cfg: LMConfig, ctx: MeshContext, batch: int) -> Dict[str, Spec]:
    """Each batch tensor's spec: its batch axis over dp where it divides."""
    shapes = train_shapes(cfg, batch, cfg.n_patches + 8)  # the length is not read
    return {k: ctx.batch_spec(batch, len(shape) - 1) for k, (shape, _) in shapes.items()}


def decode_inputs_structs(batch: int, *, device: DeviceLike = "meta") -> Dict[str, torch.Tensor]:
    """A decode step's inputs: ``token`` [B] and ``pos`` (a scalar)."""
    return {"token": torch.empty((batch,), dtype=torch.int32, device=device),
            "pos": torch.empty((), dtype=torch.int32, device=device)}
