"""kimi-k2-1t-a32b [moe]: trillion-param MoE, 384 experts top-8.

61L d_model=7168 64H (GQA kv=8) d_ff=2048(expert) vocab=163840
[arXiv:2501.kimi2; unverified, paper-table].  Every layer is MoE with
expert d_ff=2048; the official MLA attention and shared expert are
simplified to GQA / none, as in the reference.

Its smoke config is the CPU tests' case for top-k > 1.  At full width it
serves on one card at 1 of its 61 layers: one layer's 384 experts are
33.8 GB in bf16, so two do not fit (``launch/serve.py --layers 1``;
``chip_smoke.py``'s kimi_serve phase).  Its head_dim of 112 runs on every
attention route.
"""
from ..models.config import LMConfig, MoESpec


def config() -> LMConfig:
    return LMConfig(
        name="kimi-k2-1t-a32b",
        block_pattern="moe",
        n_layers=61,
        d_model=7168,
        n_heads=64,
        n_kv_heads=8,
        d_ff=2048,
        vocab=163840,
        moe=MoESpec(n_experts=384, top_k=8, d_ff_expert=2048),
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name="kimi-smoke",
        block_pattern="moe",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=96,
        vocab=512,
        moe=MoESpec(n_experts=8, top_k=2, d_ff_expert=96),
    )
