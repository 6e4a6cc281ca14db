"""A training step's model FLOPs, the numerator of MFU.

6 x (parameters that take part in a matrix product) x tokens, plus the
mixer's forward and backward (3 x its forward's products), at the real
vocabulary.  The parameters are a frozen copy of
``repro_torch.models.config.LMConfig.param_count`` for the dense and
mamba2 patterns, less the embedding lookup: every block's weights and the
output head, tied or not.  The rematerialised forward is not counted.
"""
from __future__ import annotations

from typing import Any, Mapping

from . import flash_attention, ssd_scan


def matmul_params(cfg: Mapping[str, Any]) -> int:
    d, v, L = cfg["d_model"], cfg["vocab"], cfg["n_layers"]
    if cfg["block_pattern"] == "dense":
        hd = cfg.get("head_dim") or d // cfg["n_heads"]
        nh, nkv, f = cfg["n_heads"], cfg["n_kv_heads"], cfg["d_ff"]
        per_layer = d * nh * hd + 2 * d * nkv * hd + nh * hd * d + 3 * d * f
    elif cfg["block_pattern"] == "mamba2":
        s = cfg["ssm"]
        di = s["expand"] * d
        nh = di // s["head_dim"]
        bc = 2 * s["n_groups"] * s["d_state"]
        per_layer = (d * (2 * di + bc + nh) + di * d + s["d_conv"] * (di + bc)
                     + 2 * nh + di)
    else:
        raise ValueError(f"no model FLOPs for block pattern {cfg['block_pattern']!r}")
    return L * per_layer + v * d


def mixer_flops(cfg: Mapping[str, Any], batch: int, seq: int) -> float:
    """The mixer's forward and backward over all layers: 3 x its forward."""
    L = cfg["n_layers"]
    if cfg["block_pattern"] == "dense":
        d = cfg["d_model"]
        hd = cfg.get("head_dim") or d // cfg["n_heads"]
        fwd, _ = flash_attention.forward(batch, cfg["n_heads"], cfg["n_kv_heads"], seq, seq,
                                         hd, causal=True)
    else:
        s = cfg["ssm"]
        nh = s["expand"] * cfg["d_model"] // s["head_dim"]
        fwd, _ = ssd_scan.forward(batch, seq, nh, s["head_dim"], s["n_groups"], s["d_state"],
                                  s["chunk"])
    return 3.0 * L * fwd


def step_flops(cfg: Mapping[str, Any], batch: int, seq: int) -> float:
    return 6.0 * matmul_params(cfg) * batch * seq + mixer_flops(cfg, batch, seq)
