"""The language model's configuration: all six block patterns of the
reference and its two frontends.

The port of the JAX package's ``repro.models.config``, with every field
the port reads: ``attn_mode`` picks the tensor-parallel head layout on a
mesh (``models.layers.attn_shard_mode``).  The MoE ``router_jitter`` and
``max_seq`` are read by no code of the reference either; both are left
out.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

BLOCK_PATTERNS = ("dense", "gemma2", "moe", "mamba2", "zamba2", "encoder")
FRONTENDS = (None, "frames", "patches")


@dataclass(frozen=True)
class MoESpec:
    """Top-k routed experts: ``n_experts`` SwiGLU experts of width
    ``d_ff_expert``, ``top_k`` of them per token."""

    n_experts: int
    top_k: int
    d_ff_expert: int


@dataclass(frozen=True)
class SSMSpec:
    """A Mamba2 (SSD) block: ``d_inner = expand * d_model`` split into
    heads of ``head_dim``; B and C of width ``d_state`` per group, shared
    by the ``n_inner / n_groups`` heads of a group; a causal depthwise
    convolution of width ``d_conv``; the scan in chunks of ``chunk``."""

    d_state: int
    head_dim: int = 64
    expand: int = 2
    d_conv: int = 4
    n_groups: int = 1
    chunk: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class LMConfig:
    """One architecture.  ``block_pattern`` selects the layer stack:

    dense    uniform pre-norm attention + MLP blocks
    gemma2   dense blocks with sandwich norms; even layers attend within
             ``sliding_window``, odd layers globally
    moe      attention + a top-k MoE MLP every layer (``moe``)
    mamba2   pure SSD blocks, attention-free (``ssm``)
    zamba2   mamba2 blocks, with one *shared* dense block applied after
             every ``hybrid_every`` of them
    encoder  bidirectional dense blocks without rope; no decode

    ``norm`` is ``"rmsnorm"`` or ``"layernorm"``; ``mlp`` is ``"swiglu"``,
    ``"geglu"`` or ``"gelu"``; ``sliding_window``, ``attn_softcap``,
    ``logit_softcap``, ``q_scale`` and ``embed_scale`` act as in the
    reference; ``frontend`` is None (token ids), ``"frames"`` (precomputed
    frame embeddings in place of the embedding table) or ``"patches"``
    (``n_patches`` precomputed patch embeddings before the tokens');
    ``dtype`` names the weights' torch dtype."""

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    block_pattern: str = "dense"
    head_dim: Optional[int] = None  # default d_model // n_heads
    rope_theta: float = 10_000.0
    norm: str = "rmsnorm"
    mlp: str = "swiglu"
    causal: bool = True
    tie_embeddings: bool = False
    sliding_window: Optional[int] = None
    attn_softcap: Optional[float] = None
    logit_softcap: Optional[float] = None
    q_scale: Optional[float] = None  # default head_dim**-0.5
    embed_scale: bool = False  # multiply embeddings by sqrt(d_model)
    moe: Optional[MoESpec] = None
    ssm: Optional[SSMSpec] = None
    hybrid_every: int = 6  # zamba2: the shared block after every k-th mamba block
    # the attention's tensor-parallel layout where the heads do not divide
    # the model axis: "head_dim" shards each head's dimensions (q, k and v
    # are gathered whole before the kernel), "pad" pads the query heads of
    # each KV group with zero queries to a divisible count
    attn_mode: str = "head_dim"
    frontend: Optional[str] = None  # None | "frames" | "patches"
    n_patches: int = 0  # patches: the patch prefix's length
    dtype: str = "bfloat16"

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def is_encoder(self) -> bool:
        return self.block_pattern == "encoder"

    @property
    def full_attention(self) -> bool:
        """True if some layer attends over the whole sequence without a
        window (every pattern but mamba2 and zamba2, whose shared block
        keeps a small KV budget): such archs skip the 500k cell."""
        return self.block_pattern not in ("mamba2", "zamba2")

    def q_scaling(self) -> float:
        return self.q_scale if self.q_scale is not None else self.hd**-0.5

    def kv_repeat_for(self, tp: int) -> int:
        """How many times each KV head is repeated so that the KV heads
        shard over ``tp`` (Megatron-style KV replication where kv < tp)."""
        if self.n_kv_heads >= tp:
            return 1
        return tp // math.gcd(self.n_kv_heads, tp)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head), as the
        reference counts it: zamba2's one shared block counted once, and a
        frames model's embeddings as the output head only."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        hd, nh, nkv = self.hd, self.n_heads, self.n_kv_heads
        attn = d * nh * hd + 2 * d * nkv * hd + nh * hd * d
        mlp = 3 * d * f if self.mlp in ("swiglu", "geglu") else 2 * d * f
        shared = 0
        if self.block_pattern in ("mamba2", "zamba2"):
            s = self.ssm
            di, nh_s = s.d_inner(d), s.n_heads(d)
            bc = 2 * s.n_groups * s.d_state
            in_proj = d * (2 * di + bc + nh_s)
            per_layer = in_proj + di * d + s.d_conv * (di + bc) + 2 * nh_s + di
            if self.block_pattern == "zamba2":
                shared = attn + mlp
        elif self.block_pattern == "moe":
            e = self.moe
            per_layer = attn + 3 * d * e.d_ff_expert * e.n_experts + d * e.n_experts
        else:
            per_layer = attn + mlp
        embeds = v * d * (1 if self.tie_embeddings else 2)
        if self.frontend == "frames":
            embeds = v * d
        return int(self.n_layers * per_layer + shared + embeds)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only the routed experts)."""
        if self.moe is None:
            return self.param_count()
        e = self.moe
        per_expert_layer = 3 * self.d_model * e.d_ff_expert * self.n_layers
        return int(self.param_count() - per_expert_layer * (e.n_experts - e.top_k))


# the reference's name for it; a second class *defined* as ModelConfig
# would make repro-verify's by-name resolution of the reference's ``cfg:
# ModelConfig`` annotations ambiguous (RV003 would then see no reads)
ModelConfig = LMConfig
