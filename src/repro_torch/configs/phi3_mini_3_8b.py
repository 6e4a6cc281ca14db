"""phi3-mini-3.8b [dense]: RoPE SwiGLU GQA.

32L d_model=3072 32H (GQA kv=32) d_ff=8192 vocab=32064
[arXiv:2404.14219; unverified].
"""
from ..models.config import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="phi3-mini-3.8b",
        block_pattern="dense",
        n_layers=32,
        d_model=3072,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab=32064,
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name="phi3-smoke",
        block_pattern="dense",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=512,
    )
