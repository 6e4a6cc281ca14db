"""Transformer building blocks on PyTorch: norms, RoPE, GQA attention, MLPs.

The port of the JAX package's ``repro.models.layers`` on one device: the
attention + MLP blocks of the ``dense``, ``gemma2`` (with its sandwich
norms), ``encoder`` (bidirectional, without rope) and ``zamba2`` (its
shared block) patterns, and the attention of the ``moe`` pattern.
Conventions:

  * a layer's parameters are a mapping of tensors (one layer's slice of
    the reference's stacked ``[L, ...]`` arrays, in the same layout: wq
    [d, Nh, hd], wk and wv [d, KV, hd], wo [Nh, hd, d]); norm scales and
    biases are fp32, the other weights in the model's dtype;
  * every attention call goes to ``kernels.flash_attention``, prefill and
    decode alike: the reference's ``_attend`` and ``_attend_chunked``
    compute the same function, and on one device KV heads are never
    repeated (the reference's shard modes, head padding and
    ``CHUNKED_ATTN_THRESHOLD`` only serve its tensor-parallel mesh, which
    is why ``repro.sharding`` has no counterpart here);
  * attention scores and softmax run in fp32 (inside the kernel), norms
    and RoPE in fp32, matrix products in the weights' dtype.
"""
from __future__ import annotations

import math
from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import flash_attention
from .config import LMConfig

Params = Mapping[str, torch.Tensor]


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def apply_norm(p: Params, x: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + 1e-5) * p["scale"] + p["bias"]
    else:
        var = (xf * xf).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(var + 1e-6) * p["scale"]
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (rotate-half convention)
# ---------------------------------------------------------------------------
def uses_rope(cfg: LMConfig) -> bool:
    """Whether q and k are rotated: not at ``rope_theta`` 0 and not in an
    encoder (the reference's ``_qkv``).  Callers build no cos and sin
    tables otherwise (at theta 0 they would hold NaN)."""
    return cfg.rope_theta > 0 and not cfg.is_encoder


def rope_cos_sin(positions: torch.Tensor, hd: int,
                 theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [...] -> cos, sin [..., hd/2] in fp32."""
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=positions.device) / hd
    inv = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [..., S, H, hd]; cos and sin [S, hd/2], broadcast over the heads."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def attn_scales(cfg: LMConfig, n_layers: Optional[int] = None) -> Mapping[str, float]:
    """The reference's init scales (``init_attn``): inputs 1/sqrt(d), the
    output projection 1/sqrt(2 L Nh hd), with L ``n_layers`` (default the
    model's depth; zamba2's shared block is stacked over 1)."""
    L = cfg.n_layers if n_layers is None else n_layers
    s_in = 1.0 / math.sqrt(cfg.d_model)
    s_out = 1.0 / math.sqrt(2 * max(L, 1) * cfg.n_heads * cfg.hd)
    return {"wq": s_in, "wk": s_in, "wv": s_in, "wo": s_out}


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[B, S, d] x [d, N, hd] -> [B, S, N, hd]."""
    b, s, d = x.shape
    return (x.reshape(b * s, d) @ w.reshape(d, -1)).reshape(b, s, *w.shape[1:])


def _qkv(p: Params, x: torch.Tensor, cos: Optional[torch.Tensor],
         sin: Optional[torch.Tensor],
         cfg: LMConfig) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Project and rope q, k, v: q [B, S, Nh, hd], k and v [B, S, KV, hd]
    (cos and sin are None where ``uses_rope`` is false)."""
    q = _project(x, p["wq"])
    k = _project(x, p["wk"])
    v = _project(x, p["wv"])
    if uses_rope(cfg):
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def _out(p: Params, o: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """o [B, H, S, hd] (the kernel's output) -> [B, S, d] in x's dtype."""
    b, h, s, hd = o.shape
    o = o.transpose(1, 2).reshape(b * s, h * hd)
    y = o @ p["wo"].reshape(h * hd, -1)
    return y.reshape(b, s, -1).to(x.dtype)


def apply_attn(p: Params, x: torch.Tensor, cos: Optional[torch.Tensor],
               sin: Optional[torch.Tensor], cfg: LMConfig,
               window: Optional[int]) -> torch.Tensor:
    """Full-sequence attention (prefill). x: [B, S, D].  Causal unless the
    config says otherwise or the model is an encoder (bidirectional)."""
    q, k, v = _qkv(p, x, cos, sin, cfg)
    o = flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=cfg.causal and not cfg.is_encoder, window=window, softcap=cfg.attn_softcap,
        scale=cfg.q_scaling(),
    )
    return _out(p, o, x)


def decode_attn(p: Params, x: torch.Tensor, cache_k: torch.Tensor,
                cache_v: torch.Tensor, pos: int, cos: torch.Tensor,
                sin: torch.Tensor, cfg: LMConfig,
                window: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode against a KV cache [B, Smax, KV, hd]; returns
    (y, cache_k, cache_v).  The new token's k and v are written into the
    cache at ``pos`` in place (the reference returns updated copies); the
    attention reads positions 0..pos of the cache, causally, with cos and
    sin of position ``pos``."""
    q, k, v = _qkv(p, x, cos, sin, cfg)
    cache_k[:, pos] = k[:, 0].to(cache_k.dtype)
    cache_v[:, pos] = v[:, 0].to(cache_v.dtype)
    o = flash_attention(
        q.transpose(1, 2), cache_k.transpose(1, 2), cache_v.transpose(1, 2),
        causal=True, window=window, softcap=cfg.attn_softcap,
        scale=cfg.q_scaling(), q_offset=pos,
    )
    return _out(p, o, x), cache_k, cache_v


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------
def mlp_scales(cfg: LMConfig, n_layers: Optional[int] = None) -> Mapping[str, float]:
    """The reference's init scales (``init_mlp``): inputs 1/sqrt(d), the
    down projection 1/sqrt(2 L f), with L as in ``attn_scales``; gated
    MLPs have a gate, GELU has none."""
    L = cfg.n_layers if n_layers is None else n_layers
    s_in = 1.0 / math.sqrt(cfg.d_model)
    s_out = 1.0 / math.sqrt(2 * max(L, 1) * cfg.d_ff)
    if cfg.mlp in ("swiglu", "geglu"):
        return {"w_gate": s_in, "w_up": s_in, "w_down": s_out}
    return {"w_up": s_in, "w_down": s_out}


def apply_mlp(p: Params, x: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    """SwiGLU, GeGLU or GELU (tanh approximation, as ``jax.nn.gelu``)."""
    if cfg.mlp in ("swiglu", "geglu"):
        g = x @ p["w_gate"]
        u = x @ p["w_up"]
        act = F.silu(g) if cfg.mlp == "swiglu" else F.gelu(g, approximate="tanh")
        h = act * u
    else:
        h = F.gelu(x @ p["w_up"], approximate="tanh")
    return (h @ p["w_down"]).to(x.dtype)


# ---------------------------------------------------------------------------
# the dense block
# ---------------------------------------------------------------------------
def _sandwich(p: Mapping[str, Params], name: str, h: torch.Tensor,
              cfg: LMConfig) -> torch.Tensor:
    """gemma2's post-norm ``name`` of a sublayer's output, before the
    residual add; the identity in the other patterns."""
    return apply_norm(p[name], h, cfg) if cfg.block_pattern == "gemma2" else h


def apply_dense_block(p: Mapping[str, Params], x: torch.Tensor,
                      cos: Optional[torch.Tensor], sin: Optional[torch.Tensor],
                      cfg: LMConfig, window: Optional[int]) -> torch.Tensor:
    """Pre-norm block: x + attn(norm(x)), then + mlp(norm(.)); gemma2 also
    norms each sublayer's output (``ln_attn_post``, ``ln_mlp_post``)."""
    h = apply_attn(p["attn"], apply_norm(p["ln_attn"], x, cfg), cos, sin, cfg, window)
    x = x + _sandwich(p, "ln_attn_post", h, cfg)
    h = apply_mlp(p["mlp"], apply_norm(p["ln_mlp"], x, cfg), cfg)
    return x + _sandwich(p, "ln_mlp_post", h, cfg)


def decode_dense_block(
    p: Mapping[str, Params], x: torch.Tensor, cache_k: torch.Tensor,
    cache_v: torch.Tensor, pos: int, cos: Optional[torch.Tensor],
    sin: Optional[torch.Tensor], cfg: LMConfig, window: Optional[int],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    h = apply_norm(p["ln_attn"], x, cfg)
    h, cache_k, cache_v = decode_attn(p["attn"], h, cache_k, cache_v, pos, cos,
                                      sin, cfg, window)
    x = x + _sandwich(p, "ln_attn_post", h, cfg)
    h = apply_mlp(p["mlp"], apply_norm(p["ln_mlp"], x, cfg), cfg)
    return x + _sandwich(p, "ln_mlp_post", h, cfg), cache_k, cache_v
