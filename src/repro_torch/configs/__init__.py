"""Architecture registry of the port: the reference's ten archs, over all
six block patterns and both frontends.

``get_config(id)`` and ``get_smoke_config(id)`` take the reference's
hyphened ids (``repro.configs``) and return the port's ``LMConfig``; an
unknown id raises ``KeyError``.  kimi-k2-1t-a32b serves at full width on
one card at 1 of its 61 layers (a layer's 384 experts are 33.8 GB in
bf16; its head_dim of 112 runs on every attention route).
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from ..models.config import LMConfig

_MODULES: Dict[str, str] = {
    "zamba2-7b": "zamba2_7b",
    "gemma2-27b": "gemma2_27b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "internlm2-1.8b": "internlm2_1_8b",
    "starcoder2-3b": "starcoder2_3b",
    "mamba2-1.3b": "mamba2_1_3b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "hubert-xlarge": "hubert_xlarge",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
}

ARCH_IDS: List[str] = list(_MODULES)

# the reference's archs that the port does not run (none since every
# block pattern and frontend is ported); kept so that callers listing the
# reference's archs as ``ARCH_IDS + list(UNPORTED)`` go on working
UNPORTED: Dict[str, str] = {}


def _mod(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return importlib.import_module(f".{_MODULES[arch_id]}", __package__)


def get_config(arch_id: str) -> LMConfig:
    return _mod(arch_id).config()


def get_smoke_config(arch_id: str) -> LMConfig:
    return _mod(arch_id).smoke_config()


# The shape grid of the dry run and the roofline (every arch; the skips of
# ``cell_status``), as the reference's.
SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}


def cell_status(cfg: LMConfig, shape_name: str) -> str:
    """``"run"`` or the reason the (arch, shape) cell is skipped."""
    sh = SHAPES[shape_name]
    if cfg.is_encoder and sh["kind"] == "decode":
        return "skip: encoder-only arch has no decode step"
    if shape_name == "long_500k" and cfg.full_attention:
        return "skip: full-attention arch is quadratic/KV-infeasible at 500k"
    return "run"
