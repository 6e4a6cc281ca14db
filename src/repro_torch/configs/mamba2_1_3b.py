"""mamba2-1.3b [ssm]: SSD (state-space duality), attention-free.

48L d_model=2048 d_ff=0 vocab=50280, ssm_state=128
[arXiv:2405.21060; unverified].  d_inner=2*d_model=4096, head_dim=64 ->
64 SSM heads, chunk 256; the attention fields are unused.
"""
from ..models.config import LMConfig, SSMSpec


def config() -> LMConfig:
    return LMConfig(
        name="mamba2-1.3b",
        block_pattern="mamba2",
        n_layers=48,
        d_model=2048,
        n_heads=1,  # attention-free; SSM heads derive from the ssm spec
        n_kv_heads=1,
        head_dim=64,
        d_ff=0,
        vocab=50280,
        ssm=SSMSpec(d_state=128, head_dim=64, expand=2),
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name="mamba2-smoke",
        block_pattern="mamba2",
        n_layers=3,
        d_model=64,
        n_heads=1,
        n_kv_heads=1,
        head_dim=16,
        d_ff=0,
        vocab=512,
        ssm=SSMSpec(d_state=16, head_dim=16, expand=2, chunk=32),
    )
