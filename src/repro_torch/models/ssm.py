"""Mamba2 (SSD) blocks on PyTorch: the full-sequence and decode paths.

The port of the JAX package's ``repro.models.ssm``, for the mamba2 pattern
and for zamba2's mamba2 layers, which take the same paths and the same
per-layer cache.  A layer's parameters
are a mapping of tensors in the reference's layout (one layer's slice of
its stacked ``[L, ...]`` arrays): wz and wx [d, d_inner], wB and wC [d, G
ds], wdt [d, nh], conv_x [K, d_inner], conv_B and conv_C [K, G ds] and
out_proj [d_inner, d] in the model's dtype; A_log, D and dt_bias [nh],
norm_scale [d_inner] and ln [d] in fp32.

``apply_mamba_block`` runs the scan through ``kernels.ssd_scan`` (the
kernel on the card, its plain version on the CPU) with B and C passed as
[B, S, G, ds] views, never repeated over the heads; the reference's
``ssd_chunked`` (with a starting and a final state) is the kernel's plain
version ``kernels.ssd_scan.ssd_scan_plain``.  ``decode_mamba_block`` is
the O(1) recurrent step in plain torch (the reference has no kernel for
it).

On a mesh (``ctx`` over ranks with tp > 1) the inner dimension and so the
SSM heads shard over tp (``mamba_block_specs``, the reference's layout):
every rank computes B and C whole (their projections, convolutions and
convolution windows are replicated) and scans its heads with the groups
they use (``rank_groups``: G / tp groups a rank where tp divides G, the
one group its heads lie in where G divides tp); the gated norm's mean
square is summed over tp and the output projection's partial products
too.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import sharding as sh
from ..kernels.ssd_scan import ssd_scan
from ..sharding import MeshContext, Spec
from .config import LMConfig

Params = Mapping[str, torch.Tensor]
Ctx = Optional[MeshContext]


def _tp(ctx: Ctx) -> bool:
    return ctx is not None and ctx.has_ranks and ctx.tp_size > 1


def mamba_block_specs(cfg: LMConfig, ctx: MeshContext) -> Dict[str, Spec]:
    fsdp, tp = ctx.fsdp_axis(), ctx.tp_axis()
    return {
        "wz": (None, fsdp, tp), "wx": (None, fsdp, tp), "wB": (None, fsdp, None),
        "wC": (None, fsdp, None), "wdt": (None, fsdp, tp), "conv_x": (None, None, tp),
        "conv_B": (None, None, None), "conv_C": (None, None, None), "A_log": (None, tp),
        "D": (None, tp), "dt_bias": (None, tp), "norm_scale": (None, tp), "ln": (None, None),
        "out_proj": (None, tp, fsdp),
    }


def mamba_cache_specs(cfg: LMConfig, ctx: MeshContext, batch: int) -> Dict[str, Spec]:
    """The reference's: the state's heads over tp, the convolution windows
    of B and C whole on every rank (each rank convolves them whole and then
    takes its groups, ``rank_groups``)."""
    bspec = ctx.batch_spec(batch, 0)[0]
    tp = ctx.tp_axis()
    return {"conv_x": (None, bspec, None, tp), "conv_B": (None, bspec, None, None),
            "conv_C": (None, bspec, None, None), "h": (None, bspec, tp, None, None)}


def _dims(cfg: LMConfig):
    s = cfg.ssm
    d = cfg.d_model
    return s, d, s.d_inner(d), s.n_heads(d), s.head_dim, s.d_state, s.n_groups


def mamba_shapes(cfg: LMConfig) -> Tuple[Dict[str, Tuple[int, ...]], Dict[str, Tuple[int, ...]]]:
    """One layer's weight shapes: (model dtype, fp32)."""
    s, d, di, nh, hd, ds, G = _dims(cfg)
    return (
        {"wz": (d, di), "wx": (d, di), "wB": (d, G * ds), "wC": (d, G * ds),
         "wdt": (d, nh), "conv_x": (s.d_conv, di), "conv_B": (s.d_conv, G * ds),
         "conv_C": (s.d_conv, G * ds), "out_proj": (di, d)},
        {"A_log": (nh,), "D": (nh,), "dt_bias": (nh,), "norm_scale": (di,),
         "ln": (d,)},
    )


@torch.no_grad()
def init_mamba_block(p: Mapping[str, torch.Tensor], cfg: LMConfig,
                     generator: torch.Generator) -> None:
    """Draws one layer's weights in place at the reference's scales
    (``init_mamba_block``): projections 1/sqrt(d), convolutions 0.1, the
    output projection 1/sqrt(2 L d_inner); A_log = log(linspace(1, 16,
    nh)), D = 1, dt_bias = 0 and the norm scales 1."""
    s, d, di, nh, hd, ds, G = _dims(cfg)
    s_in = 1.0 / math.sqrt(d)
    s_out = 1.0 / math.sqrt(2 * max(cfg.n_layers, 1) * di)
    scales = {"wz": s_in, "wx": s_in, "wB": s_in, "wC": s_in, "wdt": s_in,
              "conv_x": 0.1, "conv_B": 0.1, "conv_C": 0.1, "out_proj": s_out}
    for name, scale in scales.items():
        w = p[name]
        z = torch.randn(w.shape, generator=generator, dtype=torch.float32, device=w.device)
        w.copy_(z.mul_(scale))
    p["A_log"].copy_(torch.log(torch.linspace(1.0, 16.0, nh, dtype=torch.float32)))
    p["D"].fill_(1.0)
    p["dt_bias"].zero_()
    p["norm_scale"].fill_(1.0)
    p["ln"].fill_(1.0)


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution, x [B, S, C] and w [K, C] -> [B, S, C],
    as the reference writes it: K shifted products added one at a time
    in x's dtype (not ``F.conv1d``, which on the card sums in fp32 or TF32
    through cuDNN and so rounds elsewhere)."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + xp[:, i:i + s, :] * w[i]
    return out


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
         ctx: Ctx = None) -> torch.Tensor:
    """RMS norm over the last dimension; with ``ctx`` x holds this rank's
    columns of it, whose squares are summed over tp."""
    xf = x.float()
    if _tp(ctx):
        var = sh.reduce_partial((xf * xf).sum(-1, keepdim=True), ctx) / (
            x.shape[-1] * ctx.tp_size)
    else:
        var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + exp(x)), with no threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


def rank_groups(cfg: LMConfig, ctx: Ctx) -> Tuple[int, int]:
    """(first group, groups) of B and C that this rank's ``nh / tp`` SSM
    heads use, in order: all G without tensor parallelism; where tp divides
    G the rank's G / tp groups; where G divides tp the one group its heads
    lie in.  Any other (G, tp) pair cuts a group's heads over ranks
    unevenly, and raises."""
    G = cfg.ssm.n_groups
    if not _tp(ctx):
        return 0, G
    tp, r = ctx.tp_size, ctx.tp_rank()
    if G % tp == 0:
        return r * (G // tp), G // tp
    if tp % G == 0:
        return r // (tp // G), 1
    raise NotImplementedError(
        f"{cfg.name}: {G} B/C groups over tp {tp}: a rank's heads straddle a group "
        "boundary (tp must divide the groups or the groups tp)")


def _projections(p: Params, x: torch.Tensor, ctx: Ctx = None):
    """z, x, B, C, dt: on a mesh z, x and dt over this rank's heads, B and
    C whole (then entering the rank's scan: ``copy_to_tp``)."""
    xf = sh.copy_to_tp(x, ctx)
    return xf @ p["wz"], xf @ p["wx"], x @ p["wB"], x @ p["wC"], xf @ p["wdt"]


def apply_mamba_block(p: Params, x: torch.Tensor, cfg: LMConfig,
                      ctx: Ctx = None) -> torch.Tensor:
    """Full mamba2 residual block (norm -> SSD -> gated norm -> out),
    x [B, S, d]."""
    s, d, di, nh, hd, ds, G = _dims(cfg)
    tp = ctx.tp_size if _tp(ctx) else 1
    g0, ng = rank_groups(cfg, ctx)
    di, nh = di // tp, nh // tp
    b, seqlen, _ = x.shape
    res = x
    x = _rms(x, p["ln"])
    z, xc, Bc, Cc, dt = _projections(p, x, ctx)
    xc = F.silu(_causal_conv(xc, p["conv_x"]))
    Bc = F.silu(_causal_conv(Bc, p["conv_B"]))
    Cc = F.silu(_causal_conv(Cc, p["conv_C"]))
    dt = _softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xc.reshape(b, seqlen, nh, hd)
    # this rank's groups of B and C (every rank's gradients summed over tp)
    Bc, Cc = (sh.copy_to_tp(t, ctx).view(b, seqlen, G, ds)[:, :, g0:g0 + ng]
              for t in (Bc, Cc))
    y = ssd_scan(xh, dt, A, Bc, Cc, chunk=s.chunk)
    # D x is added in fp32 after the scan's rounding to x's dtype, as in
    # the reference
    y = y + xh.float() * p["D"][None, None, :, None]
    y = y.reshape(b, seqlen, di).to(x.dtype)
    y = _rms(y * F.silu(z), p["norm_scale"], ctx=ctx)
    return res + sh.reduce_from_tp(y @ p["out_proj"], ctx).to(res.dtype)


def _conv_step(state: torch.Tensor, new: torch.Tensor,
               w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """state [B, K-1, C], new [B, C] -> (out [B, C], the next state)."""
    full = torch.cat([state, new[:, None]], dim=1)  # [B, K, C]
    out = (full.float() * w.float()).sum(1).to(new.dtype)
    return out, full[:, 1:]


def decode_mamba_block(p: Params, x: torch.Tensor, cache: Mapping[str, torch.Tensor],
                       cfg: LMConfig, ctx: Ctx = None) -> torch.Tensor:
    """Single-token recurrent update, O(1) in the context length: x [B, 1,
    d] and one layer's slices of the model's decode cache
    (``TransformerLM.cache_struct``, shapes ``cache_shapes``; on a mesh
    this rank's shard of them, ``mamba_cache_specs``).  The convolution
    windows and the state are written into ``cache`` in place (the
    reference returns updated copies); returns the block's output."""
    s, d, di, nh, hd, ds, G = _dims(cfg)
    tp = ctx.tp_size if _tp(ctx) else 1
    g0, ng = rank_groups(cfg, ctx)
    di, nh = di // tp, nh // tp
    b = x.shape[0]
    res = x
    x = _rms(x, p["ln"])
    z, xc, Bc, Cc, dt = _projections(p, x[:, 0], ctx)
    xc, cx = _conv_step(cache["conv_x"], xc, p["conv_x"])
    Bc, cB = _conv_step(cache["conv_B"], Bc, p["conv_B"])
    Cc, cC = _conv_step(cache["conv_C"], Cc, p["conv_C"])
    xc, Bc, Cc = F.silu(xc), F.silu(Bc), F.silu(Cc)
    dt = _softplus(dt.float() + p["dt_bias"])  # [B, nh]
    A = -torch.exp(p["A_log"])
    xh = xc.reshape(b, nh, hd).float()
    # this rank's groups, each repeated over its heads
    Bh, Ch = (t.reshape(b, G, ds)[:, g0:g0 + ng].repeat_interleave(nh // ng, dim=1).float()
              for t in (Bc, Cc))
    decay = torch.exp(A * dt)  # [B, nh]
    h = cache["h"] * decay[:, :, None, None] + (xh * dt[..., None])[..., None] * Bh[:, :, None, :]
    y = torch.einsum("bnc,bnhc->bnh", Ch, h) + xh * p["D"][None, :, None]
    y = y.reshape(b, di).to(x.dtype)
    y = _rms((y * F.silu(z))[:, None], p["norm_scale"], ctx=ctx)[:, 0]
    cache["conv_x"].copy_(cx)
    cache["conv_B"].copy_(cB)
    cache["conv_C"].copy_(cC)
    cache["h"].copy_(h)
    return res + sh.reduce_from_tp(y @ p["out_proj"], ctx)[:, None].to(res.dtype)
