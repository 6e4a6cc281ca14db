"""llama4-scout-17b-a16e [moe]: 16 experts top-1.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].  Text backbone only,
as in the reference.  One layer's 16 experts are 4.03 GB in bf16, so the
whole model (~202 GB) does not fit one 80 GB card; it is served there at
reduced depth.
"""
from ..models.config import LMConfig, MoESpec


def config() -> LMConfig:
    return LMConfig(
        name="llama4-scout-17b-a16e",
        block_pattern="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_ff=8192,
        vocab=202048,
        moe=MoESpec(n_experts=16, top_k=1, d_ff_expert=8192),
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name="llama4-smoke",
        block_pattern="moe",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=512,
        moe=MoESpec(n_experts=4, top_k=1, d_ff_expert=128),
    )
