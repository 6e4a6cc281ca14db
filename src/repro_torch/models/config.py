"""The language model's configuration, for the ``dense`` block pattern.

The port of the JAX package's ``repro.models.config.ModelConfig``, cut to
the fields the dense path reads.  The MoE, SSM, hybrid, encoder and
frontend fields, and the tensor-parallel ``attn_mode``, belong to block
patterns and meshes the port does not run yet (ROADMAP Queue 1).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

BLOCK_PATTERNS = ("dense",)


@dataclass(frozen=True)
class LMConfig:
    """One dense architecture: uniform pre-norm attention + MLP blocks.

    ``norm`` is ``"rmsnorm"`` or ``"layernorm"``; ``mlp`` is ``"swiglu"``,
    ``"geglu"`` or ``"gelu"``; ``sliding_window``, ``attn_softcap``,
    ``logit_softcap``, ``q_scale`` and ``embed_scale`` act as in the
    reference; ``dtype`` names the weights' torch dtype."""

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
    dtype: str = "bfloat16"

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    def q_scaling(self) -> float:
        return self.q_scale if self.q_scale is not None else self.hd**-0.5

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head), the
        reference's dense branch."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        hd, nh, nkv = self.hd, self.n_heads, self.n_kv_heads
        attn = d * nh * hd + 2 * d * nkv * hd + nh * hd * d
        mlp = 3 * d * f if self.mlp in ("swiglu", "geglu") else 2 * d * f
        embeds = v * d * (1 if self.tie_embeddings else 2)
        return int(self.n_layers * (attn + mlp) + embeds)


# the reference's name for it; a second class *defined* as ModelConfig would
# make repro-verify's by-name resolution of the reference's ``cfg:
# ModelConfig`` annotations ambiguous (RV003 would then see no reads)
ModelConfig = LMConfig
