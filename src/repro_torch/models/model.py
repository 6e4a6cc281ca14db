"""TransformerLM on PyTorch: the ``dense``, ``moe`` and ``mamba2`` block
patterns, for serving.

The port of the JAX package's ``repro.models.model.TransformerLM`` for
uniform pre-norm attention + MLP blocks (internlm2, phi3, starcoder2),
attention + top-k MoE blocks (llama4-scout, kimi-k2) and attention-free
Mamba2 blocks (mamba2).  The vocabulary is padded to a multiple of
``VOCAB_PAD`` and the padded logits are pushed to -1e30, as in the
reference.  Public surface:

  TransformerLM(cfg, device=)  -> weights allocated on the device
  init(generator)              -> weights drawn at the reference's scales
  forward(tokens)              -> final-normed hidden states [B, S, d]
  prefill(tokens)              -> last-position logits [B, vocab_padded]
  cache_struct(batch, smax)    -> zeroed decode cache: KV {"k", "v"} [L,
                                  B, Smax, KV, hd], or for mamba2 the
                                  convolution windows and SSM state
                                  {"conv_x", "conv_B", "conv_C", "h"}
  decode_step(cache, token, pos) -> (cache, logits [B, vocab_padded])

As in the reference, ``prefill`` returns logits only: it hands no state
to ``decode_step``.  The weights take no gradient: this slice serves
(training waits for the attention kernel's backward, ROADMAP Queue 2
item 1, and for the training loop, Queue 1 item 13).  The other block
patterns raise ``NotImplementedError``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.engine import DeviceLike, resolve_device
from . import layers as ly
from . import moe as moe_mod
from . import ssm as ssm_mod
from .config import BLOCK_PATTERNS, LMConfig

VOCAB_PAD = 2048
Cache = Dict[str, torch.Tensor]


def padded_vocab(v: int) -> int:
    return (v + VOCAB_PAD - 1) // VOCAB_PAD * VOCAB_PAD


def _weights(shapes: Dict[str, Tuple[int, ...]], dtype: torch.dtype,
             device: torch.device) -> nn.ParameterDict:
    return nn.ParameterDict({
        name: nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                           requires_grad=False)
        for name, shape in shapes.items()
    })


def _mixed(shapes: Tuple[Dict[str, Tuple[int, ...]], Dict[str, Tuple[int, ...]]],
           dtype: torch.dtype, device: torch.device) -> nn.ParameterDict:
    """Weights in the model's dtype and in fp32, in one mapping."""
    p = _weights(shapes[0], dtype, device)
    p.update(_weights(shapes[1], torch.float32, device))
    return p


def _norm(cfg: LMConfig, device: torch.device) -> nn.ParameterDict:
    names = ("scale", "bias") if cfg.norm == "layernorm" else ("scale",)
    return _weights({n: (cfg.d_model,) for n in names}, torch.float32, device)


class DenseBlock(nn.Module):
    """One layer's weights, in the reference's layout (``attn``: wq, wk,
    wv, wo; ``mlp``: w_gate, w_up, w_down or w_up, w_down, or for the moe
    pattern ``moe``: router, w_gate, w_up, w_down; ``ln_attn`` and
    ``ln_mlp``: scale, and bias for layernorm)."""

    def __init__(self, cfg: LMConfig, dtype: torch.dtype, device: torch.device) -> None:
        super().__init__()
        d, nh, nkv, hd, f = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff
        self.attn = _weights(
            {"wq": (d, nh, hd), "wk": (d, nkv, hd), "wv": (d, nkv, hd),
             "wo": (nh, hd, d)}, dtype, device)
        if cfg.block_pattern == "moe":
            self.moe = _mixed(moe_mod.moe_shapes(cfg), dtype, device)
        else:
            mlp = {"w_up": (d, f), "w_down": (f, d)}
            if cfg.mlp in ("swiglu", "geglu"):
                mlp = {"w_gate": (d, f), **mlp}
            self.mlp = _weights(mlp, dtype, device)
        self.ln_attn = _norm(cfg, device)
        self.ln_mlp = _norm(cfg, device)

    def __getitem__(self, name: str) -> nn.ParameterDict:
        return getattr(self, name)


class TransformerLM(nn.Module):
    def __init__(self, cfg: LMConfig, *, device: DeviceLike = None) -> None:
        super().__init__()
        if cfg.block_pattern not in BLOCK_PATTERNS:
            raise NotImplementedError(
                f"{cfg.name}: block pattern {cfg.block_pattern!r} is not ported "
                f"(the port runs {BLOCK_PATTERNS}; see ROADMAP Queue 1)"
            )
        if cfg.mlp not in ("swiglu", "geglu", "gelu"):
            raise ValueError(f"unknown mlp {cfg.mlp!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = getattr(torch, cfg.dtype)
        self.vp = padded_vocab(cfg.vocab)
        dev, dt = self.device, self.dtype
        self.embed = nn.Parameter(torch.empty(self.vp, cfg.d_model, dtype=dt, device=dev),
                                  requires_grad=False)
        if cfg.block_pattern == "mamba2":
            shapes = ssm_mod.mamba_shapes(cfg)
            self.blocks = nn.ModuleList(_mixed(shapes, dt, dev)
                                        for _ in range(cfg.n_layers))
        else:
            self.blocks = nn.ModuleList(DenseBlock(cfg, dt, dev)
                                        for _ in range(cfg.n_layers))
        self.final_norm = _norm(cfg, dev)
        self.head: Optional[nn.Parameter] = None if cfg.tie_embeddings else nn.Parameter(
            torch.empty(self.vp, cfg.d_model, dtype=dt, device=dev), requires_grad=False)
        # the padded vocabulary entries' logit bias
        bias = torch.zeros(self.vp, dtype=torch.float32, device=dev)
        bias[cfg.vocab:] = -1e30
        self.register_buffer("vocab_bias", bias, persistent=False)

    # ------------------------------------------------------------------ init
    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "TransformerLM":
        """Draws every weight as the reference's ``init`` does (standard
        normals at its scales, cast to the model's dtype; norm scales 1 and
        biases 0) from ``generator``, which lives on the model's device.
        JAX's random streams differ, so the tests carry weights across
        instead (``repro_torch.convert.lm_from_reference``)."""
        cfg = self.cfg

        def fill(w: torch.Tensor, scale: float) -> None:
            z = torch.randn(w.shape, generator=generator, dtype=torch.float32,
                            device=w.device)
            w.copy_(z.mul_(scale))

        def unit(norm: nn.ParameterDict) -> None:
            norm["scale"].fill_(1.0)
            if "bias" in norm:
                norm["bias"].zero_()

        embed_scale = 1.0 / math.sqrt(cfg.d_model)
        fill(self.embed, embed_scale)
        for blk in self.blocks:
            if cfg.block_pattern == "mamba2":
                ssm_mod.init_mamba_block(blk, cfg, generator)
                continue
            ffn, scales = ((blk.moe, moe_mod.moe_scales(cfg)) if cfg.block_pattern == "moe"
                           else (blk.mlp, ly.mlp_scales(cfg)))
            for group, group_scales in ((blk.attn, ly.attn_scales(cfg)), (ffn, scales)):
                for name, scale in group_scales.items():
                    fill(group[name], scale)
            unit(blk.ln_attn)
            unit(blk.ln_mlp)
        unit(self.final_norm)
        if self.head is not None:
            fill(self.head, embed_scale)
        return self

    # ------------------------------------------------------------- embedding
    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.embed[tokens.long()].to(self.dtype)
        if self.cfg.embed_scale:
            x = x * math.sqrt(self.cfg.d_model)
        return x

    def _window_for(self, idx: int) -> Optional[int]:
        """Layer ``idx``'s attention window: the dense pattern's fixed
        sliding window, or none."""
        return self.cfg.sliding_window

    # ----------------------------------------------------------------- stack
    def _apply_stack(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if cfg.block_pattern == "mamba2":
            for blk in self.blocks:
                x = ssm_mod.apply_mamba_block(blk, x, cfg)
            return x
        pos = torch.arange(x.shape[1], device=x.device)
        cos, sin = ly.rope_cos_sin(pos, cfg.hd, cfg.rope_theta)
        for idx, blk in enumerate(self.blocks):
            w = self._window_for(idx)
            if cfg.block_pattern == "moe":
                x = x + ly.apply_attn(blk.attn, ly.apply_norm(blk.ln_attn, x, cfg),
                                      cos, sin, cfg, w)
                x = x + moe_mod.apply_moe(blk.moe, ly.apply_norm(blk.ln_mlp, x, cfg), cfg)
            else:
                x = ly.apply_dense_block(blk, x, cos, sin, cfg, w)
        return x

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """fp32 logits of hidden states x [..., d] over the padded
        vocabulary: products of the weights' values summed in fp32 (the
        reference's ``preferred_element_type=float32``), then the softcap
        and the padded entries' -1e30."""
        cfg = self.cfg
        head = self.embed if self.head is None else self.head
        logits = F.linear(x.float(), head.float())
        if cfg.logit_softcap:
            logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
        return logits + self.vocab_bias

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, S] -> final-normed hidden states [B, S, d]."""
        x = self._apply_stack(self._embed(tokens))
        return ly.apply_norm(self.final_norm, x, self.cfg)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor) -> torch.Tensor:
        """Full-sequence forward; returns the last position's logits
        [B, vocab_padded] (fp32)."""
        return self._logits(self.forward(tokens)[:, -1:, :])[:, 0]

    # --------------------------------------------------------------- serving
    def cache_struct(self, batch: int, smax: int) -> Cache:
        """A zeroed decode cache on the model's device, in the reference's
        layout: ``k`` and ``v`` [L, B, Smax, KV, hd] in the model's dtype,
        or for mamba2 (which needs no ``smax``) ``conv_x``, ``conv_B`` and
        ``conv_C`` [L, B, K-1, C] in the model's dtype and ``h`` [L, B, nh,
        hd, ds] in fp32."""
        cfg = self.cfg
        if cfg.block_pattern == "mamba2":
            return ssm_mod.init_mamba_cache(cfg, cfg.n_layers, batch, self.dtype,
                                            self.device)
        shape = (cfg.n_layers, batch, smax, cfg.n_kv_heads, cfg.hd)
        return {n: torch.zeros(shape, dtype=self.dtype, device=self.device)
                for n in ("k", "v")}

    @torch.no_grad()
    def decode_step(self, cache: Cache, token: torch.Tensor,
                    pos: int) -> Tuple[Cache, torch.Tensor]:
        """One-token decode of token [B] at position ``pos`` (shared by the
        whole batch).  Updates the cache in place (the KV entries at
        ``pos``, or the mamba2 convolution windows and state) and returns
        it with the logits [B, vocab_padded] (fp32)."""
        cfg = self.cfg
        x = self._embed(token[:, None])
        if cfg.block_pattern == "mamba2":
            for idx, blk in enumerate(self.blocks):
                x = ssm_mod.decode_mamba_block(
                    blk, x, {n: c[idx] for n, c in cache.items()}, cfg)
        else:
            positions = torch.full((1,), pos, dtype=torch.int64, device=x.device)
            cos, sin = ly.rope_cos_sin(positions, cfg.hd, cfg.rope_theta)
            for idx, blk in enumerate(self.blocks):
                w = self._window_for(idx)
                if cfg.block_pattern == "moe":
                    a, _, _ = ly.decode_attn(
                        blk.attn, ly.apply_norm(blk.ln_attn, x, cfg), cache["k"][idx],
                        cache["v"][idx], pos, cos, sin, cfg, w)
                    x = x + a
                    x = x + moe_mod.apply_moe(blk.moe, ly.apply_norm(blk.ln_mlp, x, cfg),
                                              cfg)
                else:
                    x, _, _ = ly.decode_dense_block(
                        blk, x, cache["k"][idx], cache["v"][idx], pos, cos, sin, cfg, w)
        x = ly.apply_norm(self.final_norm, x, cfg)
        return cache, self._logits(x)[:, 0]
