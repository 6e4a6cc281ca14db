"""GraphSAGE (mean aggregator) on PyTorch: the paper's training workload.

The port of the JAX package's ``repro.models.gnn``.  Mini-batches are
fixed-fanout sampled blocks (``repro_torch.data.graph.sample_blocks``):
layer l consumes the features of its nodes and an index matrix
idx_l [n_{l-1}, K_l] mapping each layer-(l-1) node to its sampled
neighbours among layer-l nodes (-1 = padding).  Per layer:

    h_N(v) = mean_{u in N(v)} h_u               (kernels.sage_aggregate)
    h'(v)  = relu([h(v) ; h_N(v)] @ W + b)

then a bias-free linear head.  As in the reference, the blocks are
consumed outermost first, the self rows are the prefix ``h[:M]`` of the
layer's nodes, and the ReLU follows every layer, the last one too.

The aggregation's route follows the device: on the card it launches the
CUDA kernel, on the CPU it runs the kernel's plain version.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..core.engine import DeviceLike, resolve_device
from ..kernels.sage_aggregate import sage_aggregate


@dataclass(frozen=True)
class GraphSAGEConfig:
    """The reference's ``SageConfig`` without ``use_pallas``: the device
    decides the aggregation's route."""

    in_dim: int
    hidden: int = 256
    n_classes: int = 47
    n_layers: int = 3


# the reference's name for it; a second class *defined* as SageConfig would
# make repro-verify's by-name resolution of the reference's ``cfg:
# SageConfig`` annotations ambiguous (RV003 would then see no reads)
SageConfig = GraphSAGEConfig


class GraphSAGE(nn.Module):
    """``layers[l]`` maps ``[h ; h_N]`` (2·d_l wide) to d_{l+1}; ``head``
    maps the last hidden layer to the class logits.  Weights are drawn as
    the reference's ``init_sage`` draws them (normal, scaled by
    1/sqrt(2·d_l), zero biases; head scaled by 1/sqrt(hidden)) from a
    ``torch.Generator`` seeded with ``seed``; the numbers differ from
    JAX's, so the tests carry weights across instead
    (``repro_torch.convert.sage_from_reference``)."""

    def __init__(self, cfg: GraphSAGEConfig, *, device: DeviceLike = None,
                 seed: int = 0) -> None:
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        dims = [cfg.in_dim] + [cfg.hidden] * cfg.n_layers
        gen = torch.Generator().manual_seed(seed)
        self.layers = nn.ModuleList()
        for l in range(cfg.n_layers):
            lin = nn.Linear(2 * dims[l], dims[l + 1])
            with torch.no_grad():
                w = torch.randn(dims[l + 1], 2 * dims[l], generator=gen)
                lin.weight.copy_(w / math.sqrt(2 * dims[l]))
                lin.bias.zero_()
            self.layers.append(lin)
        self.head = nn.Linear(cfg.hidden, cfg.n_classes, bias=False)
        with torch.no_grad():
            w = torch.randn(cfg.n_classes, cfg.hidden, generator=gen)
            self.head.weight.copy_(w / math.sqrt(cfg.hidden))
        self.to(dev)

    def forward(self, feats: torch.Tensor, blocks: List[torch.Tensor]) -> torch.Tensor:
        """feats [n_L, in_dim] of the outermost block's nodes; blocks[0]
        maps the seed nodes, blocks[-1] the innermost layer."""
        h = feats
        n_layers = len(self.layers)
        for l, lin in enumerate(self.layers):
            idx = blocks[n_layers - 1 - l]  # consume outermost first
            agg = sage_aggregate(h, idx)
            self_h = h[: idx.shape[0]]  # block layout: targets are a prefix
            h = torch.relu(lin(torch.cat([self_h, agg], dim=-1)))
        return self.head(h)


def batch_to(
    feats, blocks, labels, device: DeviceLike = None,
) -> Dict[str, object]:
    """A sampled mini-batch (numpy arrays from ``sample_blocks``) as
    tensors on ``device``: feats float32, blocks int32, labels int64."""
    dev = resolve_device(device)
    return {
        "feats": torch.as_tensor(feats, dtype=torch.float32).to(dev),
        "blocks": [torch.as_tensor(b, dtype=torch.int32).to(dev) for b in blocks],
        "labels": torch.as_tensor(labels, dtype=torch.int64).to(dev),
    }


def sage_loss(
    model: GraphSAGE, batch: Dict,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean cross-entropy of the seed nodes' logits (``logsumexp - gold``,
    as the reference writes it) and the accuracy."""
    logits = model(batch["feats"], batch["blocks"])
    labels = batch["labels"]
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[:, None])[:, 0]
    loss = (lse - gold).mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, {"loss": loss, "acc": acc}


def sgd_step(model: nn.Module, lr: float = 0.1) -> None:
    """Plain SGD in place, ``p <- p - lr * grad``, as the reference's
    ``jax.tree.map(lambda p, g: p - lr * g, ...)``; clears the grads."""
    with torch.no_grad():
        for p in model.parameters():
            if p.grad is not None:
                p.sub_(lr * p.grad)
                p.grad = None
