"""Top-k MoE FFN on PyTorch, on one device.

The port of the JAX package's ``repro.models.moe`` for its single-device
dropless path (``apply_moe`` without a mesh: ``_moe_local`` with e0 = 0
and capacity = t k, so no token is dropped):

  1. router logits in fp32, softmax, top-k (ties to the lower expert id,
     as ``lax.top_k``); for k == 1 the weight is the sigmoid of the chosen
     logit (llama4-style), else the top-k probabilities renormalised;
  2. the (token, slot) pairs sorted stably by expert id, so each expert's
     rows are one contiguous segment, with the group sizes counted on the
     device: nothing of the layer waits for the host;
  3. the experts' SwiGLU through ``kernels.moe_gemm.moe_grouped_gemm``
     (gate, up, down: three launches a layer on the card), in place of the
     reference's ``jax.lax.ragged_dot``;
  4. the weighted rows added back to their tokens with ``index_add_`` in
     the output's dtype, the weights rounded to it first, as the
     reference's ``.at[rows].add``.  With top-1 no two rows meet; with
     top-k > 1 a token's rows meet in an order that atomics on the card
     may change.

A layer's parameters: router [d, E] fp32, w_gate and w_up [E, d, f] and
w_down [E, f, d] in the model's dtype.  ``apply_moe`` returns ``(y,
aux)`` as the reference's does: aux is the Switch-style
``load_balance_loss`` of the layer's routing, which training adds to the
loss; the serving paths ask for none (``aux=False``: the reference's jit
drops the unused value).

Expert parallelism (a mesh with tp > 1, the reference's ``shard_map``
branch): the experts shard over tp (``moe_specs``), every tp rank routes
the same tokens of its dp shard with the whole router, and computes only
its experts' rows: the (token, slot) pairs sorted by expert, the rank's
segment rotated to row 0 and cut to a static ``capacity`` (GShard-style:
``CAPACITY_FACTOR`` times its even share of the rows, rounded up to 128),
pairs past it dropped in the sorted order; the outputs are summed over tp.
The layout is static, so a fake-tensor dry run takes it too.  Without a
mesh (or at tp 1) the path above is the dropless one.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import sharding as sh
from ..kernels.moe_gemm import moe_grouped_gemm
from ..sharding import MeshContext, Spec
from .config import LMConfig

Params = Mapping[str, torch.Tensor]

CAPACITY_FACTOR = 1.25
CAPACITY_ROUND = 128  # the capacity is rounded up to a multiple of this


def moe_specs(cfg: LMConfig, ctx: MeshContext) -> Dict[str, Spec]:
    fsdp, tp = ctx.fsdp_axis(), ctx.tp_axis()
    return {"router": (None, fsdp, None), "w_gate": (None, tp, fsdp, None),
            "w_up": (None, tp, fsdp, None), "w_down": (None, tp, None, fsdp)}


def moe_shapes(cfg: LMConfig) -> Tuple[Dict[str, Tuple[int, ...]], Dict[str, Tuple[int, ...]]]:
    """One layer's MoE weight shapes: (model dtype, fp32)."""
    e = cfg.moe
    d, fe, ne = cfg.d_model, e.d_ff_expert, e.n_experts
    return ({"w_gate": (ne, d, fe), "w_up": (ne, d, fe), "w_down": (ne, fe, d)},
            {"router": (d, ne)})


def moe_scales(cfg: LMConfig) -> Mapping[str, float]:
    """The reference's init scales (``init_moe``): router, gate and up
    1/sqrt(d), down 1/sqrt(2 L f)."""
    s_in = 1.0 / math.sqrt(cfg.d_model)
    s_out = 1.0 / math.sqrt(2 * max(cfg.n_layers, 1) * cfg.moe.d_ff_expert)
    return {"router": s_in, "w_gate": s_in, "w_up": s_in, "w_down": s_out}


def _route(xt: torch.Tensor, router: torch.Tensor,
           cfg: LMConfig) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing of tokens xt [t, d]: (expert ids [t, k], weights [t,
    k] fp32, probabilities [t, E] fp32)."""
    k = cfg.moe.top_k
    logits = xt.float() @ router
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort keeps the lower id first among ties, as
    # lax.top_k does (torch.topk leaves their order unspecified)
    topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = topw[:, :k], topi[:, :k]
    if k == 1:
        weights = torch.sigmoid(torch.gather(logits, -1, topi))
    else:
        weights = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    return topi, weights, probs


def load_balance_loss(probs: torch.Tensor, expert_ids: torch.Tensor,
                      n_experts: int) -> torch.Tensor:
    """Switch-style aux loss: E * sum_e mean_prob_e * mean_assign_e (the
    reference's ``load_balance_loss``)."""
    me = probs.mean(0)
    assign = torch.zeros(n_experts, dtype=torch.float32, device=probs.device).index_add_(
        0, expert_ids.reshape(-1), torch.ones(expert_ids.numel(), dtype=torch.float32,
                                              device=probs.device))
    ce = assign / max(expert_ids.numel(), 1)
    return n_experts * (me * ce).sum()


def _expert_compute(x_rows: torch.Tensor, gs: torch.Tensor, wg: torch.Tensor,
                    wu: torch.Tensor, wd: torch.Tensor) -> torch.Tensor:
    """SwiGLU of rows sorted by expert: gate and up, silu(gate) * up in
    fp32 cast to the rows' dtype, then down; each product one grouped
    GEMM."""
    g = moe_grouped_gemm(x_rows, wg, gs)
    u = moe_grouped_gemm(x_rows, wu, gs)
    h = (F.silu(g.float()) * u).to(x_rows.dtype)
    return moe_grouped_gemm(h, wd, gs)


def _moe_local(xt: torch.Tensor, p: Params, cfg: LMConfig,
               aux: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """All tokens xt [t, d] through all experts, dropless: [t, d] in the
    experts' output dtype, and the load-balance loss when ``aux``."""
    t, d = xt.shape
    k, n_exp = cfg.moe.top_k, cfg.moe.n_experts
    topi, weights, probs = _route(xt, p["router"], cfg)
    lb = load_balance_loss(probs, topi, n_exp) if aux else None
    eids = topi.reshape(-1)
    wts = weights.reshape(-1)
    tids = torch.arange(t, device=xt.device).repeat_interleave(k)
    order = torch.argsort(eids, stable=True)
    se, st, sw = eids[order], tids[order], wts[order]
    # counted on the device (torch.bincount on a card reads the largest id
    # on the host first)
    gs = torch.zeros(n_exp, dtype=torch.int32, device=xt.device).index_add_(
        0, se, torch.ones_like(se, dtype=torch.int32))
    out_rows = _expert_compute(xt[st], gs, p["w_gate"], p["w_up"], p["w_down"])
    scale = sw.to(out_rows.dtype)
    y = torch.zeros((t, d), dtype=out_rows.dtype, device=xt.device)
    return y.index_add_(0, st, out_rows * scale[:, None]), lb


def expert_shard(xt: torch.Tensor, router: torch.Tensor, wg: torch.Tensor,
                 wu: torch.Tensor, wd: torch.Tensor, cfg: LMConfig, e0: int,
                 capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``_moe_local``: all tokens xt [t, d] routed with the
    whole router, the contribution of the local experts e0 .. e0 + E_local
    (wg, wu, wd their weights) over at most ``capacity`` rows: (y [t, d],
    the load-balance loss)."""
    topi, weights, probs = _route(xt, router, cfg)
    lb = load_balance_loss(probs, topi, cfg.moe.n_experts)
    return _expert_rows(xt, topi, weights, wg, wu, wd, e0, capacity), lb


def _expert_rows(xt: torch.Tensor, topi: torch.Tensor, weights: torch.Tensor,
                 wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor, e0: int,
                 capacity: int) -> torch.Tensor:
    """The local experts' weighted rows added back to their tokens: the
    (token, slot) pairs sorted by expert, the segment from the first local
    pair taken ``capacity`` long (wrapping), and pairs outside the local
    experts or past ``capacity`` in the sorted order dropped."""
    t, d = xt.shape
    k = topi.shape[1]
    e_local = wg.shape[0]
    # a capacity past the pairs would take pairs twice (the reference wraps
    # its index and does): at t k it takes each once, dropless
    capacity = min(capacity, t * k)
    eids, wts = topi.reshape(-1), weights.reshape(-1)
    tids = torch.arange(t, device=xt.device).repeat_interleave(k)
    order = torch.argsort(eids, stable=True)
    se, st, sw = eids[order], tids[order], wts[order]
    lo = torch.searchsorted(se, torch.tensor(e0, dtype=se.dtype, device=se.device))
    idxr = (torch.arange(capacity, device=xt.device) + lo) % (t * k)
    re = se[idxr]
    valid = (re >= e0) & (re < e0 + e_local)
    rows_idx = st[idxr]
    counts = torch.zeros(e_local, dtype=torch.int64, device=xt.device).index_add_(
        0, (re - e0).clamp(0, e_local - 1), valid.long())
    cum = torch.cumsum(counts, 0)
    gs = (cum.clamp(max=capacity) - (cum - counts).clamp(max=capacity)).to(torch.int32)
    out_rows = _expert_compute(xt[rows_idx], gs, wg, wu, wd)
    scale = (sw[idxr] * valid).to(out_rows.dtype)
    y = torch.zeros((t, d), dtype=out_rows.dtype, device=xt.device)
    return y.index_add_(0, rows_idx, out_rows * scale[:, None])


def capacity_for(t_local: int, cfg: LMConfig, tp: int) -> int:
    """A tp rank's row capacity over ``t_local`` tokens."""
    cap = int(CAPACITY_FACTOR * t_local * cfg.moe.top_k / tp + CAPACITY_ROUND - 1)
    return cap // CAPACITY_ROUND * CAPACITY_ROUND


def apply_moe(p: Params, x: torch.Tensor, cfg: LMConfig, *, aux: bool = True,
              ctx: Optional[MeshContext] = None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """MoE FFN, x [B, S, d] -> (y [B, S, d] in x's dtype, the load-balance
    loss, fp32 scalar; None when ``aux`` is false).  On a mesh with tp > 1
    x is this rank's dp shard and ``p`` holds its experts (expert
    parallel); the loss is the rank's own, its mean over dp being the
    reference's."""
    b, s, d = x.shape
    if ctx is None or not ctx.has_ranks or ctx.tp_size <= 1:
        y, lb = _moe_local(x.reshape(b * s, d), p, cfg, aux)
        return y.reshape(b, s, d).to(x.dtype), lb
    tp = ctx.tp_size
    xt = x.reshape(b * s, d)
    # every tp rank routes the same tokens alike (the routing and its loss
    # are replicated), then computes its experts' rows
    topi, weights, probs = _route(xt, p["router"], cfg)
    lb = load_balance_loss(probs, topi, cfg.moe.n_experts) if aux else None
    e_per = cfg.moe.n_experts // tp
    y = _expert_rows(sh.copy_to_tp(xt, ctx), topi, sh.copy_to_tp(weights, ctx),
                     p["w_gate"], p["w_up"], p["w_down"], ctx.tp_rank() * e_per,
                     capacity_for(xt.shape[0], cfg, tp))
    return sh.reduce_from_tp(y, ctx).reshape(b, s, d).to(x.dtype), lb
