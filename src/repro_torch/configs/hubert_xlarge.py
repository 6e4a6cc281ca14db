"""hubert-xlarge [audio]: encoder-only transformer backbone.

48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504 [arXiv:2106.07447;
unverified].  The conv feature extractor (waveform -> 50 Hz frames) is a
stub, as in the reference: the model takes precomputed frame embeddings
[B, T, d_model] and returns per-frame logits over the 504
masked-prediction clusters.  Encoder-only: bidirectional attention, no
rope (positions come from the stubbed frontend), no decode.  head_dim 80.
"""
from ..models.config import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="hubert-xlarge",
        block_pattern="encoder",
        n_layers=48,
        d_model=1280,
        n_heads=16,
        n_kv_heads=16,
        d_ff=5120,
        vocab=504,
        mlp="gelu",
        norm="layernorm",
        causal=False,
        frontend="frames",
        rope_theta=0.0,
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name="hubert-smoke",
        block_pattern="encoder",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=64,
        mlp="gelu",
        norm="layernorm",
        causal=False,
        frontend="frames",
        rope_theta=0.0,
    )
