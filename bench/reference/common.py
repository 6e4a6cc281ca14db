"""The reference's shared parts: precision, norms, RoPE, the loss, AdamW.

Every matrix product goes through ``Precision.mm``: fp32 with TF32 off,
or, for the control, both operands (and, in the backward, the incoming
gradient) rounded to fp8 e4m3 with one scale a tensor, the products summed
in fp32.  Parameters are a flat mapping name -> fp32 tensor, named as the
port names its parameters (``blocks.<l>.<group>.<name>``, ``embed``,
``head``, ``final_norm.scale``), in the layouts the configuration's
published model uses (wq [d, heads, hd], wo [heads, hd, d], head
[padded vocab, d]).
"""
from __future__ import annotations

import importlib
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0  # the largest finite float8_e4m3fn
VOCAB_PAD = 2048  # the vocabulary is padded to a multiple of this
QUERY_BLOCK = 2048  # query rows of one attention block
LOSS_ROWS = 4096  # token rows of one block of the head's cross-entropy

Params = Dict[str, torch.Tensor]


def padded_vocab(v: int) -> int:
    return -(-v // VOCAB_PAD) * VOCAB_PAD


def _fp8(t: torch.Tensor) -> torch.Tensor:
    amax = t.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


def _sum_to(g: torch.Tensor, shape: torch.Size) -> torch.Tensor:
    while g.dim() > len(shape):
        g = g.sum(0)
    for i, n in enumerate(shape):
        if n == 1 and g.shape[i] != 1:
            g = g.sum(i, keepdim=True)
    return g


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _fp8(a), _fp8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _fp8(g)
        return (_sum_to(qg @ qb.transpose(-1, -2), qa.shape),
                _sum_to(qa.transpose(-1, -2) @ qg, qb.shape))


@dataclass(frozen=True)
class Precision:
    """"float32" (the reference) or "fp8" (the control)."""

    name: str = "float32"

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "float32":
            return a @ b
        if self.name == "fp8":
            return _Fp8Matmul.apply(a, b)
        raise ValueError(f"unknown precision {self.name!r}")


@dataclass(frozen=True)
class Leaf:
    """One parameter: its name and shape, "model" (the configuration's
    dtype) or "float32", how it is drawn (("normal", scale), ("const",
    value) or ("log_linspace", lo, hi)), and whether the published model
    stacks it over the layers (weight decay falls on every leaf of two or
    more dimensions once stacked)."""

    name: str
    shape: Tuple[int, ...]
    dtype: str
    init: Tuple[Any, ...]
    stacked: bool

    @property
    def decayed(self) -> bool:
        return len(self.shape) + int(self.stacked) >= 2


def pattern(cfg: Mapping[str, Any]):
    """The module of the configuration's block pattern."""
    return importlib.import_module(f"{__package__}.{cfg['block_pattern']}")


def leaves(cfg: Mapping[str, Any]) -> List[Leaf]:
    """Every parameter of the model: the embedding, the blocks, the final
    norm and (untied) the head."""
    d, vp = cfg["d_model"], padded_vocab(cfg["vocab"])
    scale = 1.0 / math.sqrt(d)
    out = [Leaf("embed", (vp, d), "model", ("normal", scale), False)]
    out += pattern(cfg).leaves(cfg)
    out.append(Leaf("final_norm.scale", (d,), "float32", ("const", 1.0), True))
    if not cfg.get("tie_embeddings", False):
        out.append(Leaf("head", (vp, d), "model", ("normal", scale), False))
    return out


def layer(params: Mapping[str, torch.Tensor], l: int) -> Dict[str, torch.Tensor]:
    prefix = f"blocks.{l}."
    return {k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)}


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE of x [B, S, H, hd] at positions 0..S-1."""
    s, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64, device=x.device) / hd)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * inv
    cos, sin = ang.cos().float()[:, None, :], ang.sin().float()[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend(q, k, v, q0, scale, mm):
    s = mm(q, k.transpose(-1, -2)) * scale
    qi = torch.arange(q.shape[2], device=q.device)[:, None] + q0
    kj = torch.arange(k.shape[2], device=q.device)[None, :]
    s = s.masked_fill(kj > qi, float("-inf"))
    return mm(torch.softmax(s, dim=-1), v)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                     prec: Precision) -> torch.Tensor:
    """softmax(q k^T scale, causal) v, q [B, H, S, hd] over k, v [B, KV, S,
    hd] (query head h reads KV head h // (H / KV)), in blocks of query rows,
    each recomputed in the backward."""
    rep = q.shape[1] // k.shape[1]
    k, v = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    outs = []
    for q0 in range(0, q.shape[2], QUERY_BLOCK):
        q1 = min(q0 + QUERY_BLOCK, q.shape[2])
        outs.append(checkpoint(_attend, q[:, :, q0:q1], k[:, :, :q1], v[:, :, :q1], q0,
                               scale, prec.mm, use_reentrant=False))
    return torch.cat(outs, dim=2)


def _ce_sum(h, head, labels, vocab, mm):
    logits = mm(h, head.t())
    cols = torch.arange(logits.shape[-1], device=h.device)
    logits = logits.masked_fill(cols >= vocab, float("-inf"))
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp(min=0)[:, None])[:, 0]
    return torch.where(labels >= 0, lse - gold, torch.zeros_like(lse)).sum()


def loss(params: Mapping[str, torch.Tensor], tokens: torch.Tensor, labels: torch.Tensor,
         cfg: Mapping[str, Any], prec: Precision) -> torch.Tensor:
    """The causal-LM cross-entropy over the real vocabulary (the padded
    entries of the head take no probability), averaged over the labelled
    positions (labels >= 0); every layer recomputed in the backward."""
    block = pattern(cfg).block
    x = params["embed"][tokens.long()]
    for l in range(cfg["n_layers"]):
        x = checkpoint(block, layer(params, l), x, cfg, prec, use_reentrant=False)
    h = rms(x, params["final_norm.scale"], cfg["rms_norm_eps"]).reshape(-1, x.shape[-1])
    head = params["embed"] if cfg.get("tie_embeddings", False) else params["head"]
    lab = labels.reshape(-1).long()
    total = h.new_zeros(())
    for r0 in range(0, h.shape[0], LOSS_ROWS):
        total = total + checkpoint(_ce_sum, h[r0:r0 + LOSS_ROWS], head,
                                   lab[r0:r0 + LOSS_ROWS], cfg["vocab"], prec.mm,
                                   use_reentrant=False)
    return total / (lab >= 0).sum().clamp(min=1)


def schedule(opt: Mapping[str, Any], step: int) -> float:
    """Linear warm-up over ``warmup_steps``, then cosine decay to
    ``min_lr_frac`` of ``lr`` at ``total_steps``; ``step`` counts from 0."""
    warm = min(1.0, step / max(opt["warmup_steps"], 1))
    frac = min(1.0, max(0.0, (step - opt["warmup_steps"])
                        / max(opt["total_steps"] - opt["warmup_steps"], 1)))
    cos = 0.5 * (1.0 + math.cos(math.pi * frac))
    return opt["lr"] * warm * (opt["min_lr_frac"] + (1.0 - opt["min_lr_frac"]) * cos)


@torch.no_grad()
def adamw(params: Params, grads: Params, m: Params, v: Params, decayed: Mapping[str, bool],
          step: int, opt: Mapping[str, Any]) -> Dict[str, float]:
    """One AdamW step in place: the gradients clipped to a global norm of
    ``clip_norm``, bias correction from step + 1, decoupled weight decay on
    the ``decayed`` leaves.  Returns each leaf's norm of the clipped
    gradient, the gradient the update uses."""
    gnorm = torch.sqrt(sum(g.double().pow(2).sum() for g in grads.values())).item()
    scale = min(1.0, opt["clip_norm"] / max(gnorm, 1e-12))
    lr = schedule(opt, step)
    b1, b2 = opt["beta1"], opt["beta2"]
    c1, c2 = 1.0 - b1 ** (step + 1), 1.0 - b2 ** (step + 1)
    norms = {}
    for name, p in params.items():
        g = grads[name] * scale
        norms[name] = g.norm().item()
        m[name].mul_(b1).add_(g, alpha=1.0 - b1)
        v[name].mul_(b2).add_(g * g, alpha=1.0 - b2)
        upd = (m[name] / c1) / ((v[name] / c2).sqrt() + opt["eps"])
        if decayed[name]:
            upd = upd + opt["weight_decay"] * p
        p.sub_(lr * upd)
    return norms


@dataclass
class Readings:
    """What a training run is judged by: each step's loss, each leaf's norm
    of the first (clipped) gradient, and each leaf's norm of its change
    over the steps run."""

    losses: List[float]
    grad_norms: Dict[str, float]
    change_norms: Dict[str, float]
    params: Optional[Params] = None  # the weights after the steps, where kept


def train(init: Mapping[str, torch.Tensor], batches: Sequence[Mapping[str, torch.Tensor]],
          cfg: Mapping[str, Any], opt: Mapping[str, Any], prec: Precision = Precision(),
          keep: bool = False) -> Readings:
    """``len(batches)`` AdamW steps of the reference from the weights
    ``init`` (fp32 copies are made; ``init`` is left as it is), one batch a
    step (``tokens`` and ``labels`` on the device); with ``keep`` the
    readings hold the weights after the steps."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        decay = {l.name: l.decayed for l in leaves(cfg)}
        params = {n: t.detach().float().clone().requires_grad_(True) for n, t in init.items()}
        m = {n: torch.zeros_like(p) for n, p in params.items()}
        v = {n: torch.zeros_like(p) for n, p in params.items()}
        losses, first = [], None
        for i, batch in enumerate(batches):
            total = loss(params, batch["tokens"], batch["labels"], cfg, prec)
            grads = dict(zip(params, torch.autograd.grad(total, list(params.values()))))
            losses.append(total.item())
            del total
            norms = adamw(params, grads, m, v, decay, i, opt)
            del grads
            first = norms if first is None else first
        with torch.no_grad():
            change = {n: (p - init[n].float()).norm().item() for n, p in params.items()}
        return Readings(losses, first, change,
                        {n: p.detach() for n, p in params.items()} if keep else None)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
