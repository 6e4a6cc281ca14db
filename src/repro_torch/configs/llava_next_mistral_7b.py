"""llava-next-mistral-7b [vlm]: mistral-7b backbone, anyres patch prefix.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified].  The vision tower and
the anyres tiling are a stub, as in the reference: the model takes
precomputed patch embeddings [B, n_patches=2880, d_model] (5 tiles x 576)
placed before the text tokens.  Mistral's sliding window of 4096 bites
once a prefix and its text pass 4096 positions.
"""
from ..models.config import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="llava-next-mistral-7b",
        block_pattern="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab=32000,
        sliding_window=4096,
        frontend="patches",
        n_patches=2880,
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name="llava-smoke",
        block_pattern="dense",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=512,
        sliding_window=16,
        frontend="patches",
        n_patches=8,
    )
