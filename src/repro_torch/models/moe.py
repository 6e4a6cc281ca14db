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
drops the unused value).  Expert parallelism over a mesh waits for
ROADMAP Queue 1 item 14.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.moe_gemm import moe_grouped_gemm
from .config import LMConfig

Params = Mapping[str, torch.Tensor]


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


def apply_moe(p: Params, x: torch.Tensor, cfg: LMConfig, *,
              aux: bool = True) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """MoE FFN, x [B, S, d] -> (y [B, S, d] in x's dtype, the load-balance
    loss, fp32 scalar; None when ``aux`` is false)."""
    b, s, d = x.shape
    y, lb = _moe_local(x.reshape(b * s, d), p, cfg, aux)
    return y.reshape(b, s, d).to(x.dtype), lb
