"""TransformerLM on PyTorch: all six block patterns of the reference and
its two frontends, for serving.

The port of the JAX package's ``repro.models.model.TransformerLM``:
uniform pre-norm attention + MLP blocks (``dense``: internlm2, phi3,
starcoder2, llava's mistral), the same with sandwich norms and
local/global windows alternating by layer (``gemma2``), bidirectional
blocks without rope (``encoder``: hubert), attention + top-k MoE blocks
(``moe``: llama4-scout, kimi-k2), attention-free Mamba2 blocks
(``mamba2``), and Mamba2 blocks with one shared attention + MLP block
applied after every ``hybrid_every`` of them (``zamba2``).  The
``frames`` frontend takes precomputed frame embeddings in place of the
embedding table (the model has none); ``patches`` places precomputed
patch embeddings before the token embeddings.  The vocabulary is padded
to a multiple of ``VOCAB_PAD`` and the padded logits are pushed to
-1e30, as in the reference.  Public surface:

  TransformerLM(cfg, device=)  -> weights allocated on the device
  init(generator)              -> weights drawn at the reference's scales
  forward(tokens, frames=, patches=)
                               -> final-normed hidden states [B, S, d]
                                  (S counts a patch prefix too)
  prefill(tokens, frames=, patches=)
                               -> last-position logits [B, vocab_padded]
  cache_struct(batch, smax)    -> zeroed decode cache: KV {"k", "v"} [L,
                                  B, Smax, KV, hd]; for mamba2 the
                                  convolution windows and SSM state
                                  {"conv_x", "conv_B", "conv_C", "h"};
                                  for zamba2 {"mamba": those, "attn":
                                  {"k", "v"} [L // hybrid_every, B, Smax,
                                  KV, hd]}, indexed by application
  decode_step(cache, token, pos) -> (cache, logits [B, vocab_padded])
  forward_train(tokens, frames=, patches=)
                               -> (hidden states, aux): differentiable
  loss_fn(batch)               -> (total loss, metrics)     [train]

On a mesh (``shard_parameters(ctx)``, ``ctx`` a ``sharding.MeshContext``
over ranks) every parameter becomes a DTensor placed by ``param_specs``
(the reference's ``PartitionSpec`` tree, stacked over the layers): FSDP
over the dp axes and tensor parallelism over tp.  A layer gathers its
weights over dp when it runs (inside its rematerialised region, so they
are gathered again for the backward and freed between) and takes its tp
shards as plain tensors, which the kernels see; the gradients come back
summed over dp into the shards (DTensor's reduce-scatter).  The
embedding and the head are vocab-parallel where tp divides the padded
vocabulary, and the loss's logsumexp is then summed over tp.  The batch
is each rank's dp shard.

As in the reference, ``prefill`` returns logits only: it hands no state
to ``decode_step``, which takes token ids (a patch prefix is not
decoded), and an encoder has neither a cache nor a decode step.  The
weights are parameters that take gradients; the serving methods
(``forward``, ``prefill``, ``decode_step``, ``_logits``) run without
autograd.  ``forward_train`` rematerialises each layer in the backward
(``torch.utils.checkpoint``, as the reference's ``jax.checkpoint``) and
returns the MoE layers' summed load-balance loss beside the hidden
states; ``loss_fn`` is the reference's causal-LM (or per-frame) cross
entropy over the padded vocabulary.  On the card every pattern trains
through its kernels' forwards and backwards: the attention's, the MoE
grouped GEMM's and the SSD scan's (each a ``torch.autograd.Function``
around the forward launch).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import sharding as sh
from ..core.engine import DeviceLike, resolve_device
from ..obs.spans import span
from ..sharding import MeshContext, Spec, single_device_ctx
from . import layers as ly
from . import moe as moe_mod
from . import ssm as ssm_mod
from .config import BLOCK_PATTERNS, FRONTENDS, LMConfig

VOCAB_PAD = 2048
Cache = Dict[str, Any]  # tensors, or for zamba2 two mappings of tensors


def padded_vocab(v: int) -> int:
    return (v + VOCAB_PAD - 1) // VOCAB_PAD * VOCAB_PAD


def _weights(shapes: Dict[str, Tuple[int, ...]], dtype: torch.dtype,
             device: torch.device) -> nn.ParameterDict:
    return nn.ParameterDict({
        name: nn.Parameter(torch.empty(shape, dtype=dtype, device=device))
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
    ``ln_mlp``: scale, and bias for layernorm; for gemma2 also the
    sandwich norms ``ln_attn_post`` and ``ln_mlp_post``)."""

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
        if cfg.block_pattern == "gemma2":
            self.ln_attn_post = _norm(cfg, device)
            self.ln_mlp_post = _norm(cfg, device)

    def __getitem__(self, name: str) -> nn.ParameterDict:
        return getattr(self, name)


def _dtensor(p: Any) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(p, DTensor)


def _tree_get(tree: Mapping[str, Any], path: Tuple[str, ...]) -> Any:
    for k in path:
        tree = tree[k]
    return tree


class TransformerLM(nn.Module):
    def __init__(self, cfg: LMConfig, *, device: DeviceLike = None) -> None:
        super().__init__()
        self.ctx: MeshContext = single_device_ctx()
        if cfg.block_pattern not in BLOCK_PATTERNS:
            raise ValueError(f"{cfg.name}: unknown block pattern {cfg.block_pattern!r} "
                             f"(known: {BLOCK_PATTERNS})")
        if cfg.frontend not in FRONTENDS:
            raise ValueError(f"{cfg.name}: unknown frontend {cfg.frontend!r} "
                             f"(known: {FRONTENDS})")
        if cfg.frontend == "frames" and cfg.tie_embeddings:
            raise ValueError(f"{cfg.name}: a frames model has no embedding table to tie")
        if cfg.mlp not in ("swiglu", "geglu", "gelu"):
            raise ValueError(f"unknown mlp {cfg.mlp!r}")
        self.cfg = cfg
        # "meta" builds the shapes alone (the specs' and counts' tests)
        self.device = (torch.device("meta") if str(device) == "meta"
                       else resolve_device(device))
        self.dtype = getattr(torch, cfg.dtype)
        self.vp = padded_vocab(cfg.vocab)
        dev, dt = self.device, self.dtype
        # a frames model reads precomputed embeddings: no table
        self.embed: Optional[nn.Parameter] = None if cfg.frontend == "frames" else (
            nn.Parameter(torch.empty(self.vp, cfg.d_model, dtype=dt, device=dev)))
        self.shared: Optional[DenseBlock] = None
        if cfg.block_pattern in ("mamba2", "zamba2"):
            shapes = ssm_mod.mamba_shapes(cfg)
            self.blocks = nn.ModuleList(_mixed(shapes, dt, dev)
                                        for _ in range(cfg.n_layers))
            if cfg.block_pattern == "zamba2":
                self.shared = DenseBlock(cfg, dt, dev)
        else:
            self.blocks = nn.ModuleList(DenseBlock(cfg, dt, dev)
                                        for _ in range(cfg.n_layers))
        self.final_norm = _norm(cfg, dev)
        self.head: Optional[nn.Parameter] = None if cfg.tie_embeddings else nn.Parameter(
            torch.empty(self.vp, cfg.d_model, dtype=dt, device=dev))
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

        def dense(blk: DenseBlock, n_layers: int) -> None:
            ffn, scales = ((blk.moe, moe_mod.moe_scales(cfg)) if cfg.block_pattern == "moe"
                           else (blk.mlp, ly.mlp_scales(cfg, n_layers)))
            for group, group_scales in ((blk.attn, ly.attn_scales(cfg, n_layers)),
                                        (ffn, scales)):
                for name, scale in group_scales.items():
                    fill(group[name], scale)
            for name, norm in blk.named_children():
                if name.startswith("ln_"):
                    unit(norm)

        embed_scale = 1.0 / math.sqrt(cfg.d_model)
        if self.embed is not None:
            fill(self.embed, embed_scale)
        for blk in self.blocks:
            if cfg.block_pattern in ("mamba2", "zamba2"):
                ssm_mod.init_mamba_block(blk, cfg, generator)
            else:
                dense(blk, cfg.n_layers)
        if self.shared is not None:  # the reference stacks it over 1 layer
            dense(self.shared, 1)
        unit(self.final_norm)
        if self.head is not None:
            fill(self.head, embed_scale)
        return self

    # ------------------------------------------------------------- embedding
    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        table = self._local(self.embed)
        if self._vocab_tp:  # this rank's rows of the table; the rows summed over tp
            off, n = self._vocab_offset(table.shape[0]), table.shape[0]
            ids = tokens.long() - off
            hit = (ids >= 0) & (ids < n)
            x = table[ids.clamp(0, n - 1)] * hit[..., None].to(table.dtype)
            x = sh.reduce_from_tp(x, self.ctx).to(self.dtype)
        else:
            x = table[tokens.long()].to(self.dtype)
        if self.cfg.embed_scale:
            x = x * math.sqrt(self.cfg.d_model)
        return x

    def _window_for(self, idx: int) -> Optional[int]:
        """Layer ``idx``'s attention window: for gemma2 ``sliding_window``
        on even layers and none on odd ones (the reference's 1e9 stands
        for none), else the config's fixed window, or none."""
        cfg = self.cfg
        if cfg.block_pattern == "gemma2" and idx % 2 == 1:
            return None
        return cfg.sliding_window

    def _rope(self, positions: torch.Tensor):
        """cos and sin of ``positions``, or (None, None) where the model
        does not rotate (``layers.uses_rope``)."""
        if not ly.uses_rope(self.cfg):
            return None, None
        return ly.rope_cos_sin(positions, self.cfg.hd, self.cfg.rope_theta)

    def _inputs(self, tokens: Optional[torch.Tensor], frames: Optional[torch.Tensor],
                patches: Optional[torch.Tensor]) -> torch.Tensor:
        """The first block's input [B, S, d] in the model's dtype: the frame
        embeddings (``frames`` frontend), or the token embeddings, after the
        patch embeddings (``patches`` frontend)."""
        cfg = self.cfg
        if cfg.frontend == "frames":
            if frames is None or tokens is not None or patches is not None:
                raise ValueError(f"{cfg.name} reads frame embeddings (frames=) alone")
            return frames.to(self.dtype)
        if frames is not None:
            raise ValueError(f"{cfg.name} has no frames frontend")
        if (patches is None) != (cfg.frontend != "patches"):
            raise ValueError(f"{cfg.name}: patches= goes with the patches frontend "
                             f"(frontend {cfg.frontend!r})")
        x = self._embed(tokens)
        if patches is not None:
            x = torch.cat([patches.to(self.dtype), x], dim=1)
        return x

    # ----------------------------------------------------------------- stack
    def _moe_layer(self, blk: DenseBlock, x: torch.Tensor, cos, sin,
                   window: Optional[int], aux: bool):
        """One moe-pattern layer: (x after it, its load-balance loss or
        None)."""
        cfg, ctx = self.cfg, self.ctx
        blk = self._local(blk)
        x = x + ly.apply_attn(blk["attn"], ly.apply_norm(blk["ln_attn"], x, cfg), cos, sin,
                              cfg, window, ctx)
        m, lb = moe_mod.apply_moe(blk["moe"], ly.apply_norm(blk["ln_mlp"], x, cfg), cfg,
                                  aux=aux, ctx=ctx)
        return x + m, lb

    def _apply_stack(self, x: torch.Tensor,
                     train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """The blocks over x [B, S, d]: (x, aux), aux the sum of the MoE
        layers' load-balance losses (fp32; 0 without MoE layers, and
        unless ``train``).  With ``train`` each layer (for zamba2 each
        mamba layer and each application of the shared block) is
        rematerialised in the backward, as the reference's scan body under
        ``jax.checkpoint``."""
        cfg, ctx, loc = self.cfg, self.ctx, self._local
        cos, sin = (None, None) if cfg.block_pattern == "mamba2" else self._rope(
            torch.arange(x.shape[1], device=x.device))
        aux = torch.zeros((), dtype=torch.float32, device=x.device)

        def run(fn, h):
            if not train:
                return fn(h)

            def block(h):  # rematerialised: the recompute opens the span again
                with span("model.block"):
                    return fn(h)

            return checkpoint(block, h, use_reentrant=False)

        if cfg.block_pattern in ("mamba2", "zamba2"):
            # zamba2: the shared block after each full group of
            # hybrid_every mamba blocks; the trailing ones run alone
            for idx, blk in enumerate(self.blocks):
                x = run(lambda h, blk=blk: ssm_mod.apply_mamba_block(loc(blk), h, cfg, ctx), x)
                if self.shared is not None and (idx + 1) % cfg.hybrid_every == 0:
                    x = run(lambda h: ly.apply_dense_block(loc(self.shared), h, cos, sin, cfg,
                                                           None, ctx), x)
            return x, aux
        for idx, blk in enumerate(self.blocks):
            w = self._window_for(idx)
            if cfg.block_pattern == "moe":
                x, lb = run(lambda h, blk=blk, w=w: self._moe_layer(blk, h, cos, sin, w,
                                                                    train), x)
                if lb is not None:
                    aux = aux + lb
            else:
                x = run(lambda h, blk=blk, w=w: ly.apply_dense_block(loc(blk), h, cos, sin,
                                                                     cfg, w, ctx), x)
        return x, aux

    def _head_logits(self, x: torch.Tensor) -> torch.Tensor:
        """fp32 logits of hidden states x [..., d] over the padded
        vocabulary: products of the weights' values summed in fp32 (the
        reference's ``preferred_element_type=float32``), then the softcap
        and the padded entries' -1e30."""
        cfg = self.cfg
        head = self._local(self.embed if self.head is None else self.head)
        bias = self.vocab_bias
        if self._vocab_tp:  # this rank's columns of the vocabulary
            x = sh.copy_to_tp(x, self.ctx)
            bias = bias[self._vocab_offset(head.shape[0]):][:head.shape[0]]
        logits = F.linear(x.float(), head.float())
        if cfg.logit_softcap:
            logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
        return logits + bias

    @torch.no_grad()
    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """``_head_logits`` for serving (no autograd), over the whole
        vocabulary."""
        logits = self._head_logits(x)
        return sh.gather_from_tp(logits, -1, self.ctx) if self._vocab_tp else logits

    @torch.no_grad()
    def forward(self, tokens: Optional[torch.Tensor] = None, *,
                frames: Optional[torch.Tensor] = None,
                patches: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens [B, S] -> final-normed hidden states [B, S, d].  A
        ``frames`` model takes ``frames`` [B, T, d] in place of tokens; a
        ``patches`` model also takes ``patches`` [B, P, d] (P may be 0),
        and returns [B, P + S, d]."""
        x, _ = self._apply_stack(self._inputs(tokens, frames, patches))
        return ly.apply_norm(self._local(self.final_norm), x, self.cfg)

    @torch.no_grad()
    def prefill(self, tokens: Optional[torch.Tensor] = None, *,
                frames: Optional[torch.Tensor] = None,
                patches: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Full-sequence forward (inputs as ``forward``); returns the last
        position's logits [B, vocab_padded] (fp32)."""
        h = self.forward(tokens, frames=frames, patches=patches)
        return self._logits(h[:, -1:, :])[:, 0]

    # -------------------------------------------------------------- training
    def leaf_groups(self) -> List[Tuple[Tuple[str, ...], List[nn.Parameter], bool]]:
        """The reference's parameter tree over the port's parameters:
        ``(path, parameters, stacked)`` per reference leaf, in the order
        its tree flattens (keys sorted at every level).  A stacked leaf is
        its parameters stacked on a new axis 0: the blocks' over the layers
        (``("blocks", group, name)``, or ``("blocks", name)`` for the mamba
        patterns), ``final_norm``'s and zamba2's ``shared`` block's over
        one; ``embed`` and ``head`` are one parameter each, unstacked."""
        out: List[Tuple[Tuple[str, ...], List[nn.Parameter], bool]] = []
        if self.embed is not None:
            out.append((("embed",), [self.embed], False))
        if self.head is not None:
            out.append((("head",), [self.head], False))
        for name, w in self.final_norm.items():
            out.append((("final_norm", name), [w], True))

        def stacked(prefix: str, layers: List[nn.Module]) -> None:
            first = layers[0]
            if isinstance(first, nn.ParameterDict):  # a mamba layer
                for name in first:
                    out.append(((prefix, name), [blk[name] for blk in layers], True))
                return
            for group, mod in first.named_children():
                for name in mod:
                    out.append(((prefix, group, name),
                                [blk[group][name] for blk in layers], True))

        stacked("blocks", list(self.blocks))
        if self.shared is not None:
            stacked("shared", [self.shared])
        return sorted(out, key=lambda item: item[0])

    # ------------------------------------------------------------------ mesh
    def param_specs(self, ctx: Optional[MeshContext] = None) -> Dict[str, Any]:
        """The reference's ``param_specs`` over ``ctx`` (default the
        model's): a spec per reference leaf, stacked leaves with their
        leading layer axis (None), the vocabulary on tp where tp divides
        the padded vocabulary."""
        cfg, ctx = self.cfg, ctx or self.ctx
        fsdp, tp = ctx.fsdp_axis(), ctx.tp_axis()
        vocab_tp = tp if self.vp % max(ctx.tp_size, 1) == 0 else None
        p: Dict[str, Any] = {}
        if cfg.frontend != "frames":
            p["embed"] = (vocab_tp, fsdp)
        if cfg.block_pattern in ("mamba2", "zamba2"):
            p["blocks"] = ssm_mod.mamba_block_specs(cfg, ctx)
        elif cfg.block_pattern == "moe":
            p["blocks"] = {"attn": ly.attn_specs(cfg, ctx), "ln_attn": ly.norm_specs(cfg, ctx),
                           "ln_mlp": ly.norm_specs(cfg, ctx),
                           "moe": moe_mod.moe_specs(cfg, ctx)}
        else:
            p["blocks"] = ly.dense_block_specs(cfg, ctx)
        if cfg.block_pattern == "zamba2":
            p["shared"] = ly.dense_block_specs(cfg, ctx)
        p["final_norm"] = ly.norm_specs(cfg, ctx)
        if not cfg.tie_embeddings:
            p["head"] = (vocab_tp, fsdp)
        return p

    def parameter_specs(self, ctx: Optional[MeshContext] = None
                        ) -> List[Tuple[str, nn.Parameter, Spec]]:
        """(name, parameter, its own spec) for every parameter: a stacked
        leaf's spec without its layer axis."""
        specs = self.param_specs(ctx)
        out = []
        for name, param in self.named_parameters():
            path = tuple(k for k in name.split(".") if not k.isdigit())
            spec = _tree_get(specs, path)
            out.append((name, param, spec[1:] if path[0] in ("blocks", "shared",
                                                             "final_norm") else spec))
        return out

    def shard_parameters(self, ctx: MeshContext) -> "TransformerLM":
        """Place every parameter on ``ctx``'s mesh of ranks as a DTensor by
        its spec (each rank keeps its shard of the whole value it holds)."""
        from torch.distributed.tensor import DTensor

        names = ctx.mesh.mesh_dim_names
        for name, param, spec in self.parameter_specs(ctx):
            local = ctx.shard(param.detach(), spec).clone()
            new = nn.Parameter(DTensor.from_local(local, ctx.mesh, sh.placements(spec, names),
                                                  run_check=False, shape=param.shape,
                                                  stride=param.stride()))
            owner, _, leaf = name.rpartition(".")
            mod = self.get_submodule(owner) if owner else self
            if isinstance(mod, nn.ParameterDict):
                mod[leaf] = new
            else:
                setattr(mod, leaf, new)
        self.ctx = ctx
        return self

    def _local(self, p: Any) -> Any:
        """A parameter (or a layer's nested mapping of them) as the plain
        tensors the layer runs on: a DTensor gathered over the dp axes
        (its gradient summed back over dp into the shard), this rank's tp
        shard; anything else as it is (everything, without ranks)."""
        if not self.ctx.has_ranks:
            return p
        if isinstance(p, (nn.ParameterDict, dict)):
            return {k: self._local(v) for k, v in p.items()}
        if isinstance(p, DenseBlock):
            return {k: self._local(v) for k, v in p.named_children()}
        if not _dtensor(p):
            return p
        from torch.distributed.tensor import Partial, Replicate

        dp = [n in self.ctx.dp for n in p.device_mesh.mesh_dim_names]
        gathered = [Replicate() if d else pl for d, pl in zip(dp, p.placements)]
        grads = [Partial() if d else pl for d, pl in zip(dp, p.placements)]
        return p.redistribute(p.device_mesh, gathered).to_local(grad_placements=grads)

    @property
    def _vocab_tp(self) -> bool:
        return self.ctx.has_ranks and self.ctx.tp_size > 1 and self.vp % self.ctx.tp_size == 0

    def _vocab_offset(self, n_local: int) -> int:
        return self.ctx.tp_rank() * n_local if self._vocab_tp else 0

    def forward_train(self, tokens: Optional[torch.Tensor] = None, *,
                      frames: Optional[torch.Tensor] = None,
                      patches: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``forward`` with autograd and each layer rematerialised in the
        backward; returns (final-normed hidden states, aux) with aux the
        MoE layers' summed load-balance loss (the reference's
        ``forward``)."""
        with span("model.embed"):
            x = self._inputs(tokens, frames, patches)
        x, aux = self._apply_stack(x, train=True)
        return ly.apply_norm(self._local(self.final_norm), x, self.cfg), aux

    def loss_fn(self, batch: Mapping[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The reference's ``loss_fn``: causal-LM (or, for frames, per-frame)
        cross entropy over the padded vocabulary, labels < 0 ignored (a
        patch prefix gets -1 labels); returns ``(total, metrics)`` with
        ``total = loss + 0.01 * aux_loss``, ``aux_loss`` the summed
        load-balance loss over ``n_layers`` and ``tokens`` the count of
        labelled positions (at least 1).  ``batch`` holds ``labels`` [B, S]
        and ``tokens``, ``frames`` or ``tokens`` and ``patches`` as
        ``forward`` takes them."""
        cfg = self.cfg
        x, aux = self.forward_train(batch.get("tokens"), frames=batch.get("frames"),
                                    patches=batch.get("patches"))
        with span("model.head_loss"):
            logits = self._head_logits(x)
            labels = batch["labels"].long()
            if cfg.frontend == "patches":
                pad = torch.full((labels.shape[0], batch["patches"].shape[1]), -1,
                                 dtype=labels.dtype, device=labels.device)
                labels = torch.cat([pad, labels], dim=1)
            mask = labels >= 0
            if self._vocab_tp:  # the logsumexp and the gold logit summed over tp
                ctx, n = self.ctx, logits.shape[-1]
                m = sh.tp_max(logits.amax(-1), ctx)
                lse = m + torch.log(sh.reduce_from_tp(torch.exp(logits - m[..., None]).sum(-1),
                                                      ctx))
                ids = labels.clamp(min=0) - self._vocab_offset(n)
                hit = (ids >= 0) & (ids < n)
                gold = torch.gather(logits, -1, ids.clamp(0, n - 1)[..., None])[..., 0]
                gold = sh.reduce_from_tp(torch.where(hit, gold, torch.zeros_like(gold)), ctx)
            else:
                lse = torch.logsumexp(logits, dim=-1)
                gold = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
            per_tok = torch.where(mask, lse - gold, torch.zeros_like(lse))
            aux = aux / max(cfg.n_layers, 1)
            if self.ctx.has_ranks and self.ctx.dp_size > 1:
                # this dp shard's share: its token losses over the whole batch's
                # count and its aux over dp; the gradients sum over dp
                ntok = self._dp_sum(mask.sum().float()).clamp(min=1)
                loss, aux = per_tok.sum() / ntok, aux / self.ctx.dp_size
                metrics = {"loss": self._dp_sum(loss.detach()),
                           "aux_loss": self._dp_sum(aux.detach()), "tokens": ntok}
                return loss + 0.01 * aux, metrics
            ntok = mask.sum().clamp(min=1)
            loss = per_tok.sum() / ntok
            metrics = {"loss": loss, "aux_loss": aux, "tokens": ntok}
            return loss + 0.01 * metrics["aux_loss"], metrics

    def _dp_sum(self, x: torch.Tensor) -> torch.Tensor:
        for a in self.ctx.dp:
            x = sh.all_reduce(x, self.ctx.group(a))
        return x

    # --------------------------------------------------------------- serving
    def cache_specs(self, batch: int, ctx: Optional[MeshContext] = None) -> Dict[str, Any]:
        """The reference's decode cache specs over ``ctx`` (default the
        model's): the KV entries' batch over dp, or where the batch does
        not divide dp (long-context decode at batch 1) their positions;
        their KV heads over tp in "heads" mode; the mamba state's heads
        over tp."""
        cfg, ctx = self.cfg, ctx or self.ctx
        bspec = ctx.batch_spec(batch, 0)[0]
        seq_ax = ctx.dp_axis() if (bspec is None and ctx.dp) else None
        kv_tp = ctx.tp_axis() if ly.attn_shard_mode(cfg, ctx) == "heads" else None
        kv = (None, bspec, seq_ax, kv_tp, None)
        if cfg.block_pattern in ("mamba2", "zamba2"):
            mamba = ssm_mod.mamba_cache_specs(cfg, ctx, batch)
            return mamba if cfg.block_pattern == "mamba2" else {
                "mamba": mamba, "attn": {"k": kv, "v": kv}}
        return {"k": kv, "v": kv}

    def cache_shapes(self, batch: int, smax: int) -> Dict[str, Any]:
        """The whole decode cache's shapes and dtypes, as ``cache_struct``
        lays it out (on a mesh with every repeated KV head,
        ``layers.kv_eff_heads``)."""
        cfg = self.cfg
        kv = ((batch, smax, ly.kv_eff_heads(cfg, self.ctx), cfg.hd), self.dtype)
        if cfg.block_pattern in ("mamba2", "zamba2"):
            k, G, ds = cfg.ssm.d_conv - 1, cfg.ssm.n_groups, cfg.ssm.d_state
            di, nh = cfg.ssm.d_inner(cfg.d_model), cfg.ssm.n_heads(cfg.d_model)
            L = cfg.n_layers
            mamba = {"conv_x": ((L, batch, k, di), self.dtype),
                     "conv_B": ((L, batch, k, G * ds), self.dtype),
                     "conv_C": ((L, batch, k, G * ds), self.dtype),
                     "h": ((L, batch, nh, cfg.ssm.head_dim, ds), torch.float32)}
            if cfg.block_pattern == "mamba2":
                return mamba
            n_apps = cfg.n_layers // cfg.hybrid_every
            return {"mamba": mamba, "attn": {n: ((n_apps,) + kv[0], kv[1]) for n in "kv"}}
        return {n: ((cfg.n_layers,) + kv[0], kv[1]) for n in "kv"}

    def cache_struct(self, batch: int, smax: int) -> Cache:
        """A zeroed decode cache on the model's device, in the reference's
        layout: ``k`` and ``v`` [L, B, Smax, KV, hd] in the model's dtype;
        for mamba2 (which needs no ``smax``) ``conv_x``, ``conv_B`` and
        ``conv_C`` [L, B, K-1, C] in the model's dtype and ``h`` [L, B, nh,
        hd, ds] in fp32; for zamba2 ``{"mamba": those, "attn": {"k", "v"}}``
        with one KV entry per application of the shared block, [L //
        hybrid_every, B, Smax, KV, hd].  An encoder has no cache.  On a
        mesh each tensor is this rank's shard by ``cache_specs``."""
        cfg = self.cfg
        if cfg.is_encoder:
            raise ValueError(f"{cfg.name}: an encoder has no decode cache")
        specs = self.cache_specs(batch)
        sizes = sh.mesh_shape(self.ctx.mesh) if self.ctx.mesh is not None else {}

        def zeros(shape_dt, spec):
            if isinstance(shape_dt, dict):
                return {n: zeros(shape_dt[n], spec[n]) for n in shape_dt}
            shape, dt = shape_dt
            if sizes:
                shape = sh.local_shape(shape, spec, sizes)
            return torch.zeros(shape, dtype=dt, device=self.device)

        return zeros(self.cache_shapes(batch, smax), specs)

    @torch.no_grad()
    def decode_step(self, cache: Cache, token: torch.Tensor,
                    pos: int) -> Tuple[Cache, torch.Tensor]:
        """One-token decode of token [B] at position ``pos`` (shared by the
        whole batch).  Updates the cache in place (the KV entries at
        ``pos``, the mamba2 convolution windows and state, or both for
        zamba2) and returns it with the logits [B, vocab_padded] (fp32).
        An encoder has no decode."""
        cfg = self.cfg
        if cfg.is_encoder:
            raise ValueError(f"{cfg.name}: an encoder has no decode step")
        x = self._embed(token[:, None])
        cos, sin = (None, None) if cfg.block_pattern == "mamba2" else self._rope(
            torch.full((1,), pos, dtype=torch.int64, device=x.device))
        ctx, loc = self.ctx, self._local
        if cfg.block_pattern in ("mamba2", "zamba2"):
            mamba = cache if cfg.block_pattern == "mamba2" else cache["mamba"]
            for idx, blk in enumerate(self.blocks):
                x = ssm_mod.decode_mamba_block(
                    loc(blk), x, {n: c[idx] for n, c in mamba.items()}, cfg, ctx)
                if self.shared is not None and (idx + 1) % cfg.hybrid_every == 0:
                    app = idx // cfg.hybrid_every  # the shared block's application
                    x, _, _ = ly.decode_dense_block(
                        loc(self.shared), x, cache["attn"]["k"][app],
                        cache["attn"]["v"][app], pos, cos, sin, cfg, None, ctx)
        else:
            for idx, blk in enumerate(self.blocks):
                w = self._window_for(idx)
                p = loc(blk)
                if cfg.block_pattern == "moe":
                    a, _, _ = ly.decode_attn(
                        p["attn"], ly.apply_norm(p["ln_attn"], x, cfg), cache["k"][idx],
                        cache["v"][idx], pos, cos, sin, cfg, w, ctx)
                    x = x + a
                    x = x + moe_mod.apply_moe(p["moe"], ly.apply_norm(p["ln_mlp"], x, cfg),
                                              cfg, aux=False, ctx=ctx)[0]
                else:
                    x, _, _ = ly.decode_dense_block(
                        p, x, cache["k"][idx], cache["v"][idx], pos, cos, sin, cfg, w, ctx)
        x = ly.apply_norm(self._local(self.final_norm), x, cfg)
        return cache, self._logits(x)[:, 0]
