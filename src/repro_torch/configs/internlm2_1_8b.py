"""internlm2-1.8b [dense]: GQA.

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92544
[arXiv:2403.17297; hf].
"""
from ..models.config import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="internlm2-1.8b",
        block_pattern="dense",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=8,
        d_ff=8192,
        vocab=92544,
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name="internlm2-smoke",
        block_pattern="dense",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=512,
    )
