"""The dense block of the reference (internlm2): pre-norm RMSNorm, GQA
causal attention with rotate-half RoPE, then a SwiGLU MLP, each added to
the residual stream.  Initial scales: inputs 1/sqrt(d), the output
projections 1/sqrt(2 L N) with N their input width; norm scales 1."""
from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping

import torch
import torch.nn.functional as F

from .common import Leaf, Precision, causal_attention, rms, rope


def _hd(cfg: Mapping[str, Any]) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]


def leaves(cfg: Mapping[str, Any]) -> List[Leaf]:
    d, nh, nkv, f, L = (cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], cfg["d_ff"],
                        cfg["n_layers"])
    hd = _hd(cfg)
    s_in = 1.0 / math.sqrt(d)
    out = []
    for l in range(L):
        p = f"blocks.{l}."
        out += [
            Leaf(p + "attn.wq", (d, nh, hd), "model", ("normal", s_in), True),
            Leaf(p + "attn.wk", (d, nkv, hd), "model", ("normal", s_in), True),
            Leaf(p + "attn.wv", (d, nkv, hd), "model", ("normal", s_in), True),
            Leaf(p + "attn.wo", (nh, hd, d), "model",
                 ("normal", 1.0 / math.sqrt(2 * L * nh * hd)), True),
            Leaf(p + "mlp.w_gate", (d, f), "model", ("normal", s_in), True),
            Leaf(p + "mlp.w_up", (d, f), "model", ("normal", s_in), True),
            Leaf(p + "mlp.w_down", (f, d), "model", ("normal", 1.0 / math.sqrt(2 * L * f)), True),
            Leaf(p + "ln_attn.scale", (d,), "float32", ("const", 1.0), True),
            Leaf(p + "ln_mlp.scale", (d,), "float32", ("const", 1.0), True),
        ]
    return out


def block(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: Mapping[str, Any],
          prec: Precision) -> torch.Tensor:
    b, s, d = x.shape
    nh, nkv, hd, eps = cfg["n_heads"], cfg["n_kv_heads"], _hd(cfg), cfg["rms_norm_eps"]
    h = rms(x, p["ln_attn.scale"], eps).reshape(b * s, d)
    q = prec.mm(h, p["attn.wq"].reshape(d, nh * hd)).reshape(b, s, nh, hd)
    k = prec.mm(h, p["attn.wk"].reshape(d, nkv * hd)).reshape(b, s, nkv, hd)
    v = prec.mm(h, p["attn.wv"].reshape(d, nkv * hd)).reshape(b, s, nkv, hd)
    q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    o = causal_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                         hd ** -0.5, prec)
    o = o.transpose(1, 2).reshape(b * s, nh * hd)
    x = x + prec.mm(o, p["attn.wo"].reshape(nh * hd, d)).reshape(b, s, d)
    h = rms(x, p["ln_mlp.scale"], eps).reshape(b * s, d)
    a = F.silu(prec.mm(h, p["mlp.w_gate"])) * prec.mm(h, p["mlp.w_up"])
    return x + prec.mm(a, p["mlp.w_down"]).reshape(b, s, d)
