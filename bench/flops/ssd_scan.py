"""The SSD scan's operations and bytes a call, x [b, s, h, hd], B and C
[b, s, g, ds], chunks of q rows.

Frozen copies of ``repro_torch.kernels.ssd_scan.cost`` and
``backward_cost``: forward per (row, group, chunk) the
causal C B^T, per (row, head, chunk) the causal W x product, the carried
state's C h and the state update, 2 flops a product, x and y moved once,
dt, B and C read once; backward C B^T once a group, four causal products
and five state products a head, x, dy, B, C and dt read and dx, dB, dC and
ddt written once.
"""
from __future__ import annotations

from typing import Tuple


def forward(b: int, s: int, h: int, hd: int, g: int, ds: int, q: int,
            elt: int = 2) -> Tuple[float, float]:
    pairs = q * (q + 1) // 2
    flops = b * (s // q) * (g * 2 * pairs * ds + h * (2 * pairs * hd + 4 * q * hd * ds))
    return float(flops), float(elt * (2 * b * s * h * hd + 2 * b * s * g * ds)
                               + 4 * (b * s * h + h))


def backward(b: int, s: int, h: int, hd: int, g: int, ds: int, q: int,
             elt: int = 2) -> Tuple[float, float]:
    pairs = q * (q + 1) // 2
    flops = b * (s // q) * (g * 2 * pairs * ds
                            + h * (2 * pairs * (2 * hd + 2 * ds) + 10 * q * hd * ds))
    return float(flops), float(elt * (3 * b * s * h * hd + 4 * b * s * g * ds)
                               + 4 * (2 * b * s * h + 2 * h))
