"""Architecture registry of the port: the ``dense`` archs without a frontend.

``get_config(id)`` and ``get_smoke_config(id)`` take the reference's
hyphened ids (``repro.configs``) and return the port's ``LMConfig``.  The
reference's other archs need block patterns the port does not run yet;
asking for one raises ``NotImplementedError`` naming its ROADMAP item.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from ..models.config import LMConfig

_MODULES: Dict[str, str] = {
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "internlm2-1.8b": "internlm2_1_8b",
    "starcoder2-3b": "starcoder2_3b",
}

ARCH_IDS: List[str] = list(_MODULES)

# the reference's archs that wait for another block pattern or a frontend
UNPORTED: Dict[str, str] = {
    "gemma2-27b": "the gemma2 block pattern (ROADMAP Queue 1 item 13b)",
    "kimi-k2-1t-a32b": "models/moe.py and moe_gemm (ROADMAP Queue 1 item 11)",
    "llama4-scout-17b-a16e": "models/moe.py and moe_gemm (ROADMAP Queue 1 item 11)",
    "mamba2-1.3b": "models/ssm.py and ssd_scan (ROADMAP Queue 1 item 12)",
    "zamba2-7b": "models/ssm.py and ssd_scan (ROADMAP Queue 1 item 12)",
    "hubert-xlarge": "the encoder pattern and frames frontend (ROADMAP Queue 1 item 13c)",
    "llava-next-mistral-7b": "the patches frontend (ROADMAP Queue 1 item 13c)",
}


def _mod(arch_id: str):
    if arch_id in UNPORTED:
        raise NotImplementedError(
            f"{arch_id} is not ported yet: it needs {UNPORTED[arch_id]}"
        )
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return importlib.import_module(f".{_MODULES[arch_id]}", __package__)


def get_config(arch_id: str) -> LMConfig:
    return _mod(arch_id).config()


def get_smoke_config(arch_id: str) -> LMConfig:
    return _mod(arch_id).smoke_config()
