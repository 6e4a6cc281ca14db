"""AdamW on PyTorch, the JAX package's ``repro.train.optimizer`` leaf for leaf.

The optimizer works on the reference's parameter tree: nested mappings
whose leaves are the reference's arrays, so a transformer block's weight
is one leaf stacked over the layers ([L, ...]) and ``final_norm`` one
leaf [1, d] (``TransformerLM.leaf_groups`` gives the port's parameters
in that grouping).  That matters twice, as in the reference:

  * decoupled weight decay falls on every leaf of two or more dimensions,
    which after stacking is every leaf of the LM (norm scales, mamba's
    ``A_log``, ``D`` and ``dt_bias`` included);
  * with ``factored_v`` the second moment of a leaf whose last two
    dimensions both exceed 1 is kept as a row mean ``r`` [..., D] and a
    column mean ``c`` [..., F] (Adafactor-style), so a stacked [L, d]
    norm's column moment averages over the layers.

Everything else follows the reference: fp32 master weights and moments
(``m_dtype="bfloat16"`` keeps the first moment in bf16), global-norm
clipping of the gradients (taken in fp32), the linear-warmup
cosine-decay ``schedule`` (computed in fp32, as the reference's), bias
correction from ``step + 1``, and new compute weights cast from the
masters to each leaf's dtype.  The update writes the optimizer state in
place, one leaf at a time, so its peak memory is one leaf's temporaries.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

#: nested mappings whose leaves are tensors (or, for ``adamw_update``'s
#: ``params``, anything with a ``dtype``)
Tree = Any
Path = Tuple[str, ...]


@dataclass(frozen=True)
class AdamWSettings:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    # memory-reduced state: "bfloat16" halves the first moment
    m_dtype: str = "float32"
    factored_v: bool = False  # Adafactor-style row/col second moment (>= 2-D)


# the reference's name; a class of its own name would be confused with
# the reference's by tools.repro_verify, which resolves annotations by
# class name
AdamWConfig = AdamWSettings


def tree_items(tree: Tree, prefix: Path = ()) -> Iterator[Tuple[Path, Any]]:
    """(path, leaf) pairs with a mapping's keys sorted at every level (the
    order in which the reference's ``jax.tree`` flattens a dict); a
    factored second moment ``{"r", "c"}`` is one leaf."""
    if isinstance(tree, Mapping) and set(tree) != {"r", "c"}:
        for k in sorted(tree):
            yield from tree_items(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def tree_build(items: List[Tuple[Path, Any]]) -> Dict[str, Any]:
    """The nested mapping of (path, leaf) pairs."""
    out: Dict[str, Any] = {}
    for path, leaf in items:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def schedule(cfg: AdamWSettings, step: int) -> float:
    """The learning rate of ``step``: linear warmup over ``warmup_steps``,
    then cosine decay to ``min_lr_frac`` of ``lr`` at ``total_steps``, in
    fp32 arithmetic as the reference computes it."""
    f = np.float32
    s = f(step)
    warm = np.minimum(f(1.0), s / f(max(cfg.warmup_steps, 1)))
    frac = np.clip((s - f(cfg.warmup_steps)) / f(max(cfg.total_steps - cfg.warmup_steps, 1)),
                   f(0.0), f(1.0))
    cos = f(0.5) * (f(1.0) + np.cos(f(math.pi) * frac))
    return float(f(cfg.lr) * warm * (f(cfg.min_lr_frac) + f(1 - cfg.min_lr_frac) * cos))


def _is_factored(cfg: AdamWSettings, p: torch.Tensor) -> bool:
    return cfg.factored_v and p.dim() >= 2 and p.shape[-1] > 1 and p.shape[-2] > 1


def opt_state_specs(cfg: AdamWSettings, params: Tree, param_specs: Tree) -> Dict[str, Tree]:
    """The specs of ``adamw_init``'s trees (``sharding``'s tuples, one
    entry per dimension): master and moments as their parameters'; a
    factored second moment's ``r`` and ``c`` drop the reduced axis from
    the parameter's spec.  ``params`` holds tensors (meta ones do) or
    anything with ``shape`` and ``dim()``."""
    specs = dict(tree_items(param_specs))

    def v_spec(p: Any, spec: Tuple[Any, ...]) -> Any:
        if _is_factored(cfg, p):
            parts = tuple(spec) + (None,) * (p.dim() - len(spec))
            return {"r": parts[:-1], "c": parts[:-2] + (parts[-1],)}
        return spec

    items = list(tree_items(params))
    return {"master": param_specs, "m": param_specs,
            "v": tree_build([(n, v_spec(p, specs[n])) for n, p in items])}


def adamw_init(params: Tree, cfg: AdamWSettings = AdamWSettings(),
               whole: Optional[Mapping[Path, torch.Tensor]] = None) -> Dict[str, Tree]:
    """``{"master", "m", "v"}`` trees matching ``params``: fp32 copies of
    the weights, zero first moments in ``m_dtype`` and zero fp32 second
    moments (``{"r": [..., D], "c": [..., F]}`` for a factored leaf).  On
    a mesh ``params`` holds shards, and ``whole`` (path -> a tensor of the
    whole leaf's shape, meta will do) decides which leaves are factored."""
    mdt = getattr(torch, cfg.m_dtype)

    def v_init(path: Path, p: torch.Tensor) -> Any:
        if _is_factored(cfg, p if whole is None else whole[path]):
            return {"r": torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device),
                    "c": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32,
                                     device=p.device)}
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    items = list(tree_items(params))
    return {
        "master": tree_build([(n, p.detach().float().clone()) for n, p in items]),
        "m": tree_build([(n, torch.zeros(p.shape, dtype=mdt, device=p.device))
                         for n, p in items]),
        "v": tree_build([(n, v_init(n, p)) for n, p in items]),
    }


def global_norm(grads: Tree) -> torch.Tensor:
    """sqrt of the sum over leaves of the squared fp32 gradients."""
    total = None
    for _, g in tree_items(grads):
        sq = g.float().pow(2).sum()
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _mean(t: torch.Tensor, dim: int, leaf_dim: int, keepdim: bool = False) -> torch.Tensor:
    return t.mean(dim, keepdim=keepdim)


def _update_leaf(cfg: AdamWSettings, lr: float, c1: float, c2: float, master: torch.Tensor,
                 m: torch.Tensor, v: Any, g: torch.Tensor, mean: Any = _mean) -> None:
    """One leaf's AdamW step on fp32 gradients g, in place.  Temporaries
    are updated in place where the operation allows (the same operations
    in the same order, so the same bits), so that a leaf of N values holds
    about four more fp32 tensors of N at once: the largest leaves (an
    embedding of 200k rows) set the step's peak memory.  ``mean(t, dim,
    leaf_dim, keepdim)`` is the factored moment's mean over ``dim`` of t,
    which runs along the leaf's dimension ``leaf_dim`` (on a mesh a shard's
    mean summed over the dimension's axes)."""
    m_new = cfg.beta1 * m.float() + (1 - cfg.beta1) * g
    if isinstance(v, Mapping):  # factored second moment
        g2 = g * g
        v["r"].copy_(cfg.beta2 * v["r"] + (1 - cfg.beta2) * mean(g2, -1, -1))
        v["c"].copy_(cfg.beta2 * v["c"] + (1 - cfg.beta2) * mean(g2, -2, -2))
        del g2
        denom = torch.clamp(mean(v["r"], -1, -2, keepdim=True), min=1e-30)
        vh = (v["r"] / denom)[..., None] * v["c"][..., None, :]
        vh.div_(c2)
    else:
        v.copy_(cfg.beta2 * v + (1 - cfg.beta2) * (g * g))
        vh = v / c2
    # decoupled weight decay on leaves of two or more dimensions:
    # master -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * master)
    wd = cfg.weight_decay if master.dim() >= 2 else 0.0
    step = (m_new / c1).div_(vh.sqrt_().add_(cfg.eps))
    del vh
    master.sub_(step.add_(wd * master).mul_(lr))
    m.copy_(m_new)


@torch.no_grad()
def adamw_update(cfg: AdamWSettings, params: Tree, opt_state: Dict[str, Tree], grads: Tree,
                 step: int, *, norm: Callable[[Tree], torch.Tensor] = global_norm,
                 mean_of: Callable[[Tuple[str, ...], torch.Tensor], Any] = lambda path, g: _mean
                 ) -> Tuple[Tree, Dict[str, Tree], Dict[str, Any]]:
    """One AdamW step at ``step`` (0-based): returns (new compute weights,
    the optimizer state, metrics ``grad_norm`` and ``lr``).  ``params`` is
    read only for its leaves' dtypes (bf16 weights stay bf16, fp32 norms
    fp32); ``grads`` has the same leaves in any float dtype.  The state
    is updated in place; a new weight of an fp32 leaf is its master.  The
    gradients are clipped to a global norm of ``clip_norm`` leaf by leaf
    as they are used (no clipped copy of the tree is made).  On a mesh the
    gradients and the state are this rank's shards: ``norm(grads)`` is
    then the global norm summed over the mesh, and ``mean_of(path, g)``
    the leaf's factored mean (``_update_leaf``'s ``mean``) summed over its
    dimensions' axes."""
    gnorm = norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    lr = schedule(cfg, step)
    f = np.float32
    t = f(step) + f(1.0)
    c1 = float(f(1.0) - f(cfg.beta1) ** t)
    c2 = float(f(1.0) - f(cfg.beta2) ** t)
    masters = dict(tree_items(opt_state["master"]))
    ms = dict(tree_items(opt_state["m"]))
    vs = dict(tree_items(opt_state["v"]))
    new = []
    for (path, g), (_, like) in zip(tree_items(grads), tree_items(params)):
        _update_leaf(cfg, lr, c1, c2, masters[path], ms[path], vs[path], g.float() * scale,
                     mean_of(path, g))
        new.append((path, masters[path].to(like.dtype)))
    return tree_build(new), opt_state, {"grad_norm": gnorm, "lr": lr}
