"""zamba2-7b [hybrid]: Mamba2 backbone + shared attention blocks.

81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000, ssm_state=64
[arXiv:2411.15242; unverified].  The shared transformer block (one set of
weights, applied after every 6th mamba layer) follows the Zamba design;
per-application LoRA deltas of the official checkpoint are omitted, as in
the reference.  head_dim 3584 / 32 = 112; 112 SSM heads of 64.
"""
from ..models.config import LMConfig, SSMSpec


def config() -> LMConfig:
    return LMConfig(
        name="zamba2-7b",
        block_pattern="zamba2",
        n_layers=81,
        d_model=3584,
        n_heads=32,
        n_kv_heads=32,
        d_ff=14336,
        vocab=32000,
        ssm=SSMSpec(d_state=64, head_dim=64, expand=2),
        hybrid_every=6,
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name="zamba2-smoke",
        block_pattern="zamba2",
        n_layers=7,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=512,
        ssm=SSMSpec(d_state=16, head_dim=16, expand=2, chunk=32),
        hybrid_every=3,
    )
