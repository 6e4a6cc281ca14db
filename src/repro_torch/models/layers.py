"""Transformer building blocks on PyTorch: norms, RoPE, GQA attention, MLPs.

The port of the JAX package's ``repro.models.layers``: the attention +
MLP blocks of the ``dense``, ``gemma2`` (with its sandwich norms),
``encoder`` (bidirectional, without rope) and ``zamba2`` (its shared
block) patterns, and the attention of the ``moe`` pattern.  Conventions:

  * a layer's parameters are a mapping of tensors (one layer's slice of
    the reference's stacked ``[L, ...]`` arrays, in the same layout: wq
    [d, Nh, hd], wk and wv [d, KV, hd], wo [Nh, hd, d]); norm scales and
    biases are fp32, the other weights in the model's dtype;
  * every attention call goes to ``kernels.flash_attention``, prefill and
    decode alike: the reference's ``_attend`` and ``_attend_chunked``
    compute the same function, so ``CHUNKED_ATTN_THRESHOLD`` has no
    counterpart;
  * attention scores and softmax run in fp32 (inside the kernel), norms
    and RoPE in fp32, matrix products in the weights' dtype.

On a mesh (``ctx``, a ``sharding.MeshContext`` over ranks, with tp > 1)
the functions take each rank's local weight shards (``*_specs``: the
reference's specs, stacked over the layers) and run tensor-parallel,
Megatron-style: ``attn_shard_mode`` picks the reference's layout.
"heads": each rank holds Nh / tp query heads and its KV heads (the KV
heads repeated ``kv_repeat_for(tp)`` times where they do not divide tp);
"head_dim": each rank holds a slice of every head's dimensions, and q, k
and v are gathered whole before rope and the kernel (which takes whole
heads; the reference lets GSPMD sum partial scores instead), the
attention runs on every rank, and each rank's slice of the output meets
its slice of wo; "pad_heads" (``attn_mode="pad"``): stored as head_dim,
then the query heads of each KV group are padded with zero queries to a
count that divides tp and the kernel runs on each rank's heads.  The
output and MLP down projections are summed over tp.  Without a mesh
nothing of this runs and KV heads are never repeated.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import sharding as sh
from ..kernels.flash_attention import NEG_INF, flash_attention
from ..sharding import MeshContext, Spec
from .config import LMConfig

Params = Mapping[str, torch.Tensor]
Ctx = Optional[MeshContext]


def _tp(ctx: Ctx) -> bool:
    return ctx is not None and ctx.has_ranks and ctx.tp_size > 1


# ---------------------------------------------------------------------------
# the tensor-parallel layout
# ---------------------------------------------------------------------------
def attn_shard_mode(cfg: LMConfig, ctx: Ctx) -> str:
    """"heads" when the (repeated) head axes divide tp; otherwise
    "head_dim", or "pad_heads" for ``attn_mode="pad"``."""
    tp = ctx.tp_size if ctx is not None else 1
    if tp <= 1:
        return "heads"
    kv_eff = cfg.n_kv_heads * cfg.kv_repeat_for(tp)
    if cfg.n_heads % tp == 0 and kv_eff % tp == 0 and cfg.n_heads % kv_eff == 0:
        return "heads"
    if cfg.attn_mode == "pad":
        return "pad_heads"
    if cfg.hd % tp:
        raise ValueError(f"{cfg.name}: neither heads ({cfg.n_heads}) nor head_dim "
                         f"({cfg.hd}) shard over tp={tp}")
    return "head_dim"


def padded_head_layout(cfg: LMConfig, tp: int) -> Tuple[int, int, int]:
    """(query heads a KV group, padded to, effective KV heads) of the
    "pad_heads" mode: each group's query heads padded so that the group
    splits evenly over its repeated KV heads."""
    nkv = cfg.n_kv_heads
    qpg = cfg.n_heads // nkv
    step = tp // math.gcd(nkv, tp)
    qpg_pad = -(-qpg // step) * step
    kv_eff = nkv * cfg.kv_repeat_for(tp)
    if (nkv * qpg_pad) % tp or (nkv * qpg_pad) % kv_eff:
        raise ValueError(f"{cfg.name}: no padded head layout over tp={tp}")
    return qpg, qpg_pad, kv_eff


def kv_eff_heads(cfg: LMConfig, ctx: Ctx) -> int:
    """The KV heads a decode cache holds on a mesh."""
    mode = attn_shard_mode(cfg, ctx)
    if mode == "heads":
        return cfg.n_kv_heads * cfg.kv_repeat_for(ctx.tp_size if ctx is not None else 1)
    if mode == "pad_heads":
        return padded_head_layout(cfg, ctx.tp_size)[2]
    return cfg.n_kv_heads


def _kv_sharded(cfg: LMConfig, ctx: MeshContext) -> bool:
    return cfg.n_kv_heads % max(ctx.tp_size, 1) == 0


def norm_specs(cfg: LMConfig, ctx: MeshContext) -> Dict[str, Spec]:
    return {n: (None, None) for n in (("scale", "bias") if cfg.norm == "layernorm"
                                       else ("scale",))}


def attn_specs(cfg: LMConfig, ctx: MeshContext) -> Dict[str, Spec]:
    fsdp, tp = ctx.fsdp_axis(), ctx.tp_axis()
    if attn_shard_mode(cfg, ctx) == "heads":
        kv_tp = tp if _kv_sharded(cfg, ctx) else None
        return {"wq": (None, fsdp, tp, None), "wk": (None, fsdp, kv_tp, None),
                "wv": (None, fsdp, kv_tp, None), "wo": (None, tp, None, fsdp)}
    return {"wq": (None, fsdp, None, tp), "wk": (None, fsdp, None, tp),
            "wv": (None, fsdp, None, tp), "wo": (None, None, tp, fsdp)}


def mlp_specs(cfg: LMConfig, ctx: MeshContext) -> Dict[str, Spec]:
    fsdp, tp = ctx.fsdp_axis(), ctx.tp_axis()
    out = {"w_up": (None, fsdp, tp), "w_down": (None, tp, fsdp)}
    if cfg.mlp in ("swiglu", "geglu"):
        out["w_gate"] = (None, fsdp, tp)
    return out


def dense_block_specs(cfg: LMConfig, ctx: MeshContext) -> Dict[str, Dict[str, Spec]]:
    p = {"attn": attn_specs(cfg, ctx), "mlp": mlp_specs(cfg, ctx),
         "ln_attn": norm_specs(cfg, ctx), "ln_mlp": norm_specs(cfg, ctx)}
    if cfg.block_pattern == "gemma2":
        p["ln_attn_post"] = norm_specs(cfg, ctx)
        p["ln_mlp_post"] = norm_specs(cfg, ctx)
    return p


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


def _qkv_tp(p: Params, x: torch.Tensor, cos: Optional[torch.Tensor],
            sin: Optional[torch.Tensor], cfg: LMConfig,
            ctx: MeshContext) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, k, v on a mesh ([B, S, heads, hd]): each rank's heads in "heads"
    and "pad_heads" mode (the KV heads repeated, the padded query heads
    zero), every head whole in "head_dim" mode."""
    mode = attn_shard_mode(cfg, ctx)
    xf = sh.copy_to_tp(x, ctx)
    rope = (lambda t: apply_rope(t, cos, sin)) if uses_rope(cfg) else (lambda t: t)
    if mode == "heads":
        q = rope(_project(xf, p["wq"]))
        if _kv_sharded(cfg, ctx):
            return q, rope(_project(xf, p["wk"])), _project(xf, p["wv"])
        rep = cfg.kv_repeat_for(ctx.tp_size)
        k, v = (t.repeat_interleave(rep, dim=2) for t in
                (rope(_project(x, p["wk"])), _project(x, p["wv"])))
        return q, sh.scatter_to_tp(k, 2, ctx), sh.scatter_to_tp(v, 2, ctx)
    q, k, v = (sh.gather_from_tp(_project(xf, p[w]), -1, ctx) for w in ("wq", "wk", "wv"))
    q, k = rope(q), rope(k)
    if mode == "head_dim":
        return q, k, v
    qpg, qpg_pad, kv_eff = padded_head_layout(cfg, ctx.tp_size)
    b, s = q.shape[:2]
    q = F.pad(q.reshape(b, s, cfg.n_kv_heads, qpg, cfg.hd), (0, 0, 0, qpg_pad - qpg))
    q = q.reshape(b, s, cfg.n_kv_heads * qpg_pad, cfg.hd)
    rep = kv_eff // cfg.n_kv_heads
    k, v = (t.repeat_interleave(rep, dim=2) for t in (k, v))
    return tuple(sh.scatter_to_tp(t, 2, ctx) for t in (q, k, v))


def _out(p: Params, o: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """o [B, H, S, hd] (the kernel's output) -> [B, S, d] in x's dtype."""
    b, h, s, hd = o.shape
    o = o.transpose(1, 2).reshape(b * s, h * hd)
    y = o @ p["wo"].reshape(h * hd, -1)
    return y.reshape(b, s, -1).to(x.dtype)


def _out_tp(p: Params, o: torch.Tensor, x: torch.Tensor, cfg: LMConfig,
            ctx: MeshContext) -> torch.Tensor:
    """The output projection on a mesh, from the kernel's o over this
    rank's heads ("heads", "pad_heads") or every head ("head_dim"): summed
    over tp."""
    mode = attn_shard_mode(cfg, ctx)
    if mode == "pad_heads":  # every rank's heads, the padding dropped
        qpg, qpg_pad, _ = padded_head_layout(cfg, ctx.tp_size)
        o = sh.gather_from_tp(o, 1, ctx)
        b, _, s, hd = o.shape
        o = o.reshape(b, cfg.n_kv_heads, qpg_pad, s, hd)[:, :, :qpg].reshape(
            b, cfg.n_heads, s, hd)
    if mode != "heads":  # this rank's slice of each head's dimensions
        o = sh.scatter_to_tp(o, -1, ctx)
    return sh.reduce_from_tp(_out(p, o, x), ctx)


def apply_attn(p: Params, x: torch.Tensor, cos: Optional[torch.Tensor],
               sin: Optional[torch.Tensor], cfg: LMConfig,
               window: Optional[int], ctx: Ctx = None) -> torch.Tensor:
    """Full-sequence attention (prefill). x: [B, S, D].  Causal unless the
    config says otherwise or the model is an encoder (bidirectional)."""
    tp = _tp(ctx)
    q, k, v = _qkv_tp(p, x, cos, sin, cfg, ctx) if tp else _qkv(p, x, cos, sin, cfg)
    o = flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=cfg.causal and not cfg.is_encoder, window=window, softcap=cfg.attn_softcap,
        scale=cfg.q_scaling(),
    )
    return _out_tp(p, o, x, cfg, ctx) if tp else _out(p, o, x)


def merge_attention_parts(o: torch.Tensor, lse: torch.Tensor,
                          reduce: Callable[[torch.Tensor, str], torch.Tensor]) -> torch.Tensor:
    """The attention over keys cut into parts, from one part's output o
    [B, H, Sq, hd] and logsumexp lse [B, H, Sq] (fp32, natural domain;
    -1e30 where the part sees no key): with ``top = reduce(lse, "max")``
    and w = exp(lse - top), sum(w o) / sum(w), the sums ``reduce(., "sum")``,
    in fp32.  ``reduce(x, op)`` combines a tensor over the parts: the
    all-reduce over the dp ranks (``_seq_sharded_decode``), or a max or sum
    over a leading dimension that stacks the parts in one process.  A part
    that sees no key weighs 0."""
    top = reduce(lse, "max")
    w = torch.exp(lse - top).unsqueeze(-1)
    return reduce(w * o.float(), "sum") / reduce(w, "sum")


def seq_shard_part(q: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                   local: int, cfg: LMConfig,
                   window: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """One rank's part of a decode over a cache whose positions are cut
    into shards: q [B, 1, H, hd] against this shard [B, sl, KV, hd], whose
    first position lies ``local`` before the query's.  Returns (o [B, H,
    1, hd], lse [B, H, 1] fp32).  Where ``local >= 0``, ``flash_attention``
    at ``q_offset = local`` with the logsumexp (the decode kernel on the
    card, the plain version on the CPU; past the shard, ``local >= sl``, it
    sees the whole shard unless the window cuts it), counted under an op
    counter at the flash kernel's formula at ``local``; where ``local <
    0`` the shard holds no key the query sees and nothing is launched: o =
    0, lse = -1e30."""
    qt = q.transpose(1, 2)
    if local < 0:
        return (torch.zeros_like(qt),
                torch.full(qt.shape[:3], NEG_INF, dtype=torch.float32, device=q.device))
    return flash_attention(qt, cache_k.transpose(1, 2), cache_v.transpose(1, 2), causal=True,
                           window=window, softcap=cfg.attn_softcap, scale=cfg.q_scaling(),
                           q_offset=local, return_lse=True)


def _seq_sharded_decode(q: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                        pos: int, cfg: LMConfig, window: Optional[int],
                        ctx: MeshContext) -> torch.Tensor:
    """One query per row against a cache whose positions are sharded over
    dp: this rank's ``sl = Smax / dp`` of them, at its local position
    ``local = pos - index sl`` (``index`` its coordinate over the dp axes,
    major first).  q [B, 1, H, hd] -> o [B, H, 1, hd].  The rank's part is
    ``seq_shard_part``; the parts are merged over dp by
    ``merge_attention_parts`` (one max and two sum all-reduces, every rank
    taking part, also one that launched nothing) in fp32 and cast once to
    q's dtype."""
    index, _ = ctx.coordinate(ctx.dp)
    o, lse = seq_shard_part(q, cache_k, cache_v, pos - index * cache_k.shape[1], cfg, window)
    groups = [ctx.group(a) for a in ctx.dp]

    def reduce(x: torch.Tensor, op: str) -> torch.Tensor:
        for grp in groups:
            x = sh.all_reduce(x, grp, op)
        return x

    return merge_attention_parts(o, lse, reduce).to(q.dtype)


def decode_attn(p: Params, x: torch.Tensor, cache_k: torch.Tensor,
                cache_v: torch.Tensor, pos: int, cos: torch.Tensor,
                sin: torch.Tensor, cfg: LMConfig,
                window: Optional[int],
                ctx: Ctx = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode against a KV cache [B, Smax, KV, hd]; returns
    (y, cache_k, cache_v).  The new token's k and v are written into the
    cache at ``pos`` in place (the reference returns updated copies); the
    attention reads positions 0..pos of the cache, causally, with cos and
    sin of position ``pos``.  On a mesh the cache is this rank's shard
    (``TransformerLM.cache_specs``): its KV heads in "heads" mode, every
    repeated KV head otherwise; positions sharded over dp where the batch
    is not (``seq_shard_ok``): each rank attends over its positions and
    the ranks' parts are merged over dp (``_seq_sharded_decode``)."""
    tp = _tp(ctx)
    q, k, v = _qkv_tp(p, x, cos, sin, cfg, ctx) if tp else _qkv(p, x, cos, sin, cfg)
    mode = attn_shard_mode(cfg, ctx) if tp else "heads"
    if mode == "pad_heads":  # the cache holds every repeated KV head
        k, v = (sh.gather_from_tp(t, 2, ctx) for t in (k, v))
    seq = ctx is not None and ctx.has_ranks and ctx.seq_shard_ok(x.shape[0])
    at = pos
    if seq:
        index, _ = ctx.coordinate(ctx.dp)
        at = pos - index * cache_k.shape[1]
    if 0 <= at < cache_k.shape[1]:
        cache_k[:, at] = k[:, 0].to(cache_k.dtype)
        cache_v[:, at] = v[:, 0].to(cache_v.dtype)
    ck, cv = cache_k, cache_v
    if mode == "pad_heads":  # this rank's repeated KV heads
        ck, cv = (sh.scatter_to_tp(t, 2, ctx) for t in (cache_k, cache_v))
    if seq:
        o = _seq_sharded_decode(q, ck, cv, pos, cfg, window, ctx)
    else:
        o = flash_attention(
            q.transpose(1, 2), ck.transpose(1, 2), cv.transpose(1, 2),
            causal=True, window=window, softcap=cfg.attn_softcap,
            scale=cfg.q_scaling(), q_offset=pos,
        )
    y = _out_tp(p, o, x, cfg, ctx) if tp else _out(p, o, x)
    return y, cache_k, cache_v


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


def apply_mlp(p: Params, x: torch.Tensor, cfg: LMConfig, ctx: Ctx = None) -> torch.Tensor:
    """SwiGLU, GeGLU or GELU (tanh approximation, as ``jax.nn.gelu``); on a
    mesh over this rank's columns of d_ff, summed over tp."""
    if _tp(ctx):
        return sh.reduce_from_tp(apply_mlp(p, sh.copy_to_tp(x, ctx), cfg), ctx)
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
                      cfg: LMConfig, window: Optional[int], ctx: Ctx = None) -> torch.Tensor:
    """Pre-norm block: x + attn(norm(x)), then + mlp(norm(.)); gemma2 also
    norms each sublayer's output (``ln_attn_post``, ``ln_mlp_post``)."""
    h = apply_attn(p["attn"], apply_norm(p["ln_attn"], x, cfg), cos, sin, cfg, window, ctx)
    x = x + _sandwich(p, "ln_attn_post", h, cfg)
    h = apply_mlp(p["mlp"], apply_norm(p["ln_mlp"], x, cfg), cfg, ctx)
    return x + _sandwich(p, "ln_mlp_post", h, cfg)


def decode_dense_block(
    p: Mapping[str, Params], x: torch.Tensor, cache_k: torch.Tensor,
    cache_v: torch.Tensor, pos: int, cos: Optional[torch.Tensor],
    sin: Optional[torch.Tensor], cfg: LMConfig, window: Optional[int], ctx: Ctx = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    h = apply_norm(p["ln_attn"], x, cfg)
    h, cache_k, cache_v = decode_attn(p["attn"], h, cache_k, cache_v, pos, cos,
                                      sin, cfg, window, ctx)
    x = x + _sandwich(p, "ln_attn_post", h, cfg)
    h = apply_mlp(p["mlp"], apply_norm(p["ln_mlp"], x, cfg), cfg, ctx)
    return x + _sandwich(p, "ln_mlp_post", h, cfg), cache_k, cache_v
