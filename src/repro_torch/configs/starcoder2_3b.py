"""starcoder2-3b [dense]: GQA (kv=2), RoPE, GELU MLP, LayerNorm.

30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152
[arXiv:2402.19173; hf].  On one device the 24 query heads read the 2 KV
heads in groups of 12.
"""
from ..models.config import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="starcoder2-3b",
        block_pattern="dense",
        n_layers=30,
        d_model=3072,
        n_heads=24,
        n_kv_heads=2,
        d_ff=12288,
        vocab=49152,
        mlp="gelu",
        norm="layernorm",
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name="starcoder2-smoke",
        block_pattern="dense",
        n_layers=3,
        d_model=64,
        n_heads=4,  # non-divisible head counts are a full-config property
        n_kv_heads=2,
        d_ff=128,
        vocab=512,
        mlp="gelu",
        norm="layernorm",
    )
