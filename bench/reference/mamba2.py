"""The Mamba2 block of the reference (arXiv:2405.21060, as the
configuration runs it): RMSNorm, the input projections (z, x, B, C, dt),
a causal depthwise convolution of width d_conv on x, B and C followed by
SiLU, dt = softplus(dt + dt_bias), A = -exp(A_log), the SSD scan
h_t = exp(A dt_t) h_{t-1} + dt_t x_t B_t^T, y_t = C_t h_t + D x_t, then
RMSNorm(y * SiLU(z)) and the output projection, added to the residual.
B and C are shared by the heads of a group.  The scan is the chunked form
of the paper's minimal SSD: within a chunk the masked decay matrix, across
chunks the carried state.  Initial scales: projections 1/sqrt(d),
convolutions 0.1, the output projection 1/sqrt(2 L d_inner); A_log =
log(linspace(1, 16)), D = 1, dt_bias = 0, norm scales 1."""
from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping

import torch
import torch.nn.functional as F

from .common import Leaf, Precision, rms


def _dims(cfg: Mapping[str, Any]):
    s, d = cfg["ssm"], cfg["d_model"]
    di = s["expand"] * d
    return s, d, di, di // s["head_dim"], s["head_dim"], s["d_state"], s["n_groups"]


def leaves(cfg: Mapping[str, Any]) -> List[Leaf]:
    s, d, di, nh, hd, ds, G = _dims(cfg)
    L, K = cfg["n_layers"], s["d_conv"]
    s_in = 1.0 / math.sqrt(d)
    out = []
    for l in range(L):
        p = f"blocks.{l}."
        out += [
            Leaf(p + "wz", (d, di), "model", ("normal", s_in), True),
            Leaf(p + "wx", (d, di), "model", ("normal", s_in), True),
            Leaf(p + "wB", (d, G * ds), "model", ("normal", s_in), True),
            Leaf(p + "wC", (d, G * ds), "model", ("normal", s_in), True),
            Leaf(p + "wdt", (d, nh), "model", ("normal", s_in), True),
            Leaf(p + "conv_x", (K, di), "model", ("normal", 0.1), True),
            Leaf(p + "conv_B", (K, G * ds), "model", ("normal", 0.1), True),
            Leaf(p + "conv_C", (K, G * ds), "model", ("normal", 0.1), True),
            Leaf(p + "out_proj", (di, d), "model",
                 ("normal", 1.0 / math.sqrt(2 * L * di)), True),
            Leaf(p + "A_log", (nh,), "float32", ("log_linspace", 1.0, 16.0), True),
            Leaf(p + "D", (nh,), "float32", ("const", 1.0), True),
            Leaf(p + "dt_bias", (nh,), "float32", ("const", 0.0), True),
            Leaf(p + "norm_scale", (di,), "float32", ("const", 1.0), True),
            Leaf(p + "ln", (d,), "float32", ("const", 1.0), True),
        ]
    return out


def _conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Causal depthwise convolution, x [B, S, C], w [K, C]: out_t =
    sum_i w_i x_{t - K + 1 + i}."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    return sum(xp[:, i:i + s] * w[i] for i in range(k))


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, chunk: int, prec: Precision) -> torch.Tensor:
    """x [b, s, h, p], dt [b, s, h], A [h], B and C [b, s, g, n] -> y [b, s,
    h, p] of h_t = exp(A dt_t) h_{t-1} + dt_t x_t B_t^T, y_t = C_t h_t."""
    b, s, h, p = x.shape
    g, n = Bm.shape[2:]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a whole number of chunks of {chunk}")
    c, rep = s // chunk, h // g
    X = (x * dt[..., None]).reshape(b, c, chunk, h, p).permute(0, 3, 1, 2, 4)  # b h c l p
    a = (A * dt).reshape(b, c, chunk, h).permute(0, 3, 1, 2)  # b h c l
    Bc = Bm.reshape(b, c, chunk, g, n).permute(0, 3, 1, 2, 4).repeat_interleave(rep, 1)
    Cc = Cm.reshape(b, c, chunk, g, n).permute(0, 3, 1, 2, 4).repeat_interleave(rep, 1)
    acs = torch.cumsum(a, dim=-1)
    keep = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp((acs[..., :, None] - acs[..., None, :]).masked_fill(~keep, float("-inf")))
    y = prec.mm(prec.mm(Cc, Bc.transpose(-1, -2)) * decay, X)  # within each chunk
    states = prec.mm((X * torch.exp(acs[..., -1:] - acs)[..., None]).transpose(-1, -2), Bc)
    carried, enter = torch.zeros_like(states[:, :, 0]), []
    for j in range(c):  # the state entering chunk j
        enter.append(carried)
        carried = torch.exp(acs[:, :, j, -1])[..., None, None] * carried + states[:, :, j]
    enter = torch.stack(enter, dim=2)  # b h c p n
    y = y + prec.mm(Cc, enter.transpose(-1, -2)) * torch.exp(acs)[..., None]
    return y.permute(0, 2, 3, 1, 4).reshape(b, s, h, p)


def block(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: Mapping[str, Any],
          prec: Precision) -> torch.Tensor:
    s, d, di, nh, hd, ds, G = _dims(cfg)
    b, sl, _ = x.shape
    eps = cfg["rms_norm_eps"]
    h = rms(x, p["ln"], eps).reshape(b * sl, d)
    z = prec.mm(h, p["wz"]).reshape(b, sl, di)
    xc = F.silu(_conv(prec.mm(h, p["wx"]).reshape(b, sl, di), p["conv_x"]))
    Bc = F.silu(_conv(prec.mm(h, p["wB"]).reshape(b, sl, G * ds), p["conv_B"]))
    Cc = F.silu(_conv(prec.mm(h, p["wC"]).reshape(b, sl, G * ds), p["conv_C"]))
    dt = prec.mm(h, p["wdt"]).reshape(b, sl, nh)
    dt = torch.logaddexp(dt + p["dt_bias"], torch.zeros_like(dt))
    xh = xc.reshape(b, sl, nh, hd)
    y = ssd(xh, dt, -torch.exp(p["A_log"]), Bc.reshape(b, sl, G, ds),
            Cc.reshape(b, sl, G, ds), s["chunk"], prec)
    y = (y + xh * p["D"][:, None]).reshape(b, sl, di)
    y = rms(y * F.silu(z), p["norm_scale"], eps).reshape(b * sl, di)
    return x + prec.mm(y, p["out_proj"]).reshape(b, sl, d)
