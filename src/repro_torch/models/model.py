"""TransformerLM on PyTorch: the ``dense`` block pattern, for serving.

The port of the JAX package's ``repro.models.model.TransformerLM`` for
uniform pre-norm attention + MLP blocks (internlm2, phi3, starcoder2).
The vocabulary is padded to a multiple of ``VOCAB_PAD`` and the padded
logits are pushed to -1e30, as in the reference.  Public surface:

  TransformerLM(cfg, device=)  -> weights allocated on the device
  init(generator)              -> weights drawn at the reference's scales
  forward(tokens)              -> final-normed hidden states [B, S, d]
  prefill(tokens)              -> last-position logits [B, vocab_padded]
  cache_struct(batch, smax)    -> zeroed KV cache {"k", "v"} [L, B, Smax, KV, hd]
  decode_step(cache, token, pos) -> (cache, logits [B, vocab_padded])

The weights take no gradient: this slice serves (training waits for the
attention kernel's backward, ROADMAP Queue 2 item 3b).  The other block
patterns and the frontends raise ``NotImplementedError``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.engine import DeviceLike, resolve_device
from . import layers as ly
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


def _norm(cfg: LMConfig, device: torch.device) -> nn.ParameterDict:
    names = ("scale", "bias") if cfg.norm == "layernorm" else ("scale",)
    return _weights({n: (cfg.d_model,) for n in names}, torch.float32, device)


class DenseBlock(nn.Module):
    """One layer's weights, in the reference's layout (``attn``: wq, wk,
    wv, wo; ``mlp``: w_gate, w_up, w_down or w_up, w_down; ``ln_attn``
    and ``ln_mlp``: scale, and bias for layernorm)."""

    def __init__(self, cfg: LMConfig, dtype: torch.dtype, device: torch.device) -> None:
        super().__init__()
        d, nh, nkv, hd, f = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff
        self.attn = _weights(
            {"wq": (d, nh, hd), "wk": (d, nkv, hd), "wv": (d, nkv, hd),
             "wo": (nh, hd, d)}, dtype, device)
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
        self.blocks = nn.ModuleList(DenseBlock(cfg, dt, dev) for _ in range(cfg.n_layers))
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
            w.copy_(z * scale)

        embed_scale = 1.0 / math.sqrt(cfg.d_model)
        fill(self.embed, embed_scale)
        attn, mlp = ly.attn_scales(cfg), ly.mlp_scales(cfg)
        for blk in self.blocks:
            for name, scale in attn.items():
                fill(blk.attn[name], scale)
            for name, scale in mlp.items():
                fill(blk.mlp[name], scale)
            for norm in (blk.ln_attn, blk.ln_mlp):
                norm["scale"].fill_(1.0)
                if "bias" in norm:
                    norm["bias"].zero_()
        self.final_norm["scale"].fill_(1.0)
        if "bias" in self.final_norm:
            self.final_norm["bias"].zero_()
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
        pos = torch.arange(x.shape[1], device=x.device)
        cos, sin = ly.rope_cos_sin(pos, cfg.hd, cfg.rope_theta)
        for idx, blk in enumerate(self.blocks):
            x = ly.apply_dense_block(blk, x, cos, sin, cfg, self._window_for(idx))
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
        """A zeroed KV cache in the reference's layout: ``k`` and ``v``
        [L, B, Smax, KV, hd] in the model's dtype, on its device."""
        cfg = self.cfg
        shape = (cfg.n_layers, batch, smax, cfg.n_kv_heads, cfg.hd)
        return {n: torch.zeros(shape, dtype=self.dtype, device=self.device)
                for n in ("k", "v")}

    @torch.no_grad()
    def decode_step(self, cache: Cache, token: torch.Tensor,
                    pos: int) -> Tuple[Cache, torch.Tensor]:
        """One-token decode of token [B] at position ``pos`` (shared by the
        whole batch).  Writes the cache in place at ``pos`` and returns it
        with the logits [B, vocab_padded] (fp32)."""
        cfg = self.cfg
        x = self._embed(token[:, None])
        positions = torch.full((1,), pos, dtype=torch.int64, device=x.device)
        cos, sin = ly.rope_cos_sin(positions, cfg.hd, cfg.rope_theta)
        for idx, blk in enumerate(self.blocks):
            x, _, _ = ly.decode_dense_block(
                blk, x, cache["k"][idx], cache["v"][idx], pos, cos, sin, cfg,
                self._window_for(idx),
            )
        x = ly.apply_norm(self.final_norm, x, cfg)
        return cache, self._logits(x)[:, 0]

