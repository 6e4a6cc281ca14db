"""The attention's operations and bytes a call.

Frozen copies of ``repro_torch.kernels.flash_attention.cost`` and
``backward_cost``: forward 4 D flops per unmasked (query, key)
pair, q and o moved once and the K and V rows the queries see read once;
backward five products per pair (10 D flops), q, k, v, o and dO read and
dq, dk, dv written once.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def mask_counts(sq: int, sk: int, causal: bool, window: Optional[int],
                offset: int = 0) -> Tuple[int, int]:
    """(unmasked (query, key) pairs, keys some query sees)."""
    i = np.arange(sq, dtype=np.int64) + offset
    hi = np.minimum(sk - 1, i) if causal else np.full(sq, sk - 1, dtype=np.int64)
    lo = np.maximum(0, i - window + 1) if window is not None else np.zeros(sq, dtype=np.int64)
    n = np.clip(hi - lo + 1, 0, None)
    seen = n > 0
    keys = int(hi[seen].max() - lo[seen].min() + 1) if seen.any() else 0
    return int(n.sum()), keys


def forward(b: int, h: int, kv: int, sq: int, sk: int, d: int, causal: bool = True,
            window: Optional[int] = None, elt: int = 2) -> Tuple[float, float]:
    pairs, keys = mask_counts(sq, sk, causal, window)
    return 4.0 * d * b * h * pairs, float(elt * (2 * b * h * sq * d + 2 * b * kv * keys * d))


def backward(b: int, h: int, kv: int, s: int, d: int, causal: bool = True,
             window: Optional[int] = None, elt: int = 2) -> Tuple[float, float]:
    pairs, _ = mask_counts(s, s, causal, window)
    return 10.0 * d * b * h * pairs, float(elt * (4 * b * h * s * d + 4 * b * kv * s * d))
