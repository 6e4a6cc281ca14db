"""gemma2-27b [gemma2]: local+global alternating attention, logit softcaps.

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000
[arXiv:2408.00118; hf].  head_dim=128 and query scale (d_model/n_heads)^-0.5
per the official config; GeGLU MLP, sandwich norms, tied embeddings,
sliding_window=4096 on even layers, attn softcap 50, final logit softcap 30.
"""
from ..models.config import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="gemma2-27b",
        block_pattern="gemma2",
        n_layers=46,
        d_model=4608,
        n_heads=32,
        n_kv_heads=16,
        head_dim=128,
        d_ff=36864,
        vocab=256000,
        mlp="geglu",
        sliding_window=4096,
        attn_softcap=50.0,
        logit_softcap=30.0,
        q_scale=(4608 / 32) ** -0.5,
        embed_scale=True,
        tie_embeddings=True,
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name="gemma2-smoke",
        block_pattern="gemma2",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=256,
        vocab=512,
        mlp="geglu",
        sliding_window=16,
        attn_softcap=50.0,
        logit_softcap=30.0,
        q_scale=16.0**-0.5,
        embed_scale=True,
        tie_embeddings=True,
    )
