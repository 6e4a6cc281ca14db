"""Namespaced seed derivation (the part of multi-job planning the search needs).

A copy of ``_splitmix64``, ``derive_seed`` and the ``SEED_NS_*`` namespace
constants of the JAX package's ``repro.core.multijob``: ETP derives each
chain's seed here, so the port's chains walk the same random streams as
the reference's.  Merged multi-job workloads come to the port later.
"""
from __future__ import annotations

_MASK64 = (1 << 64) - 1

#: disjoint namespaces for the derivation levels (arbitrary distinct
#: constants; what matters is that they differ)
SEED_NS_JOB = 0x6A6F62  # "job": per-job realization streams
SEED_NS_DRAW = 0x64726177  # "draw": per-draw merged realizations
SEED_NS_CHAIN = 0x636861696E  # "chain": per-chain ETP search streams


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    z = x
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & _MASK64


def derive_seed(base: int, namespace: int, index: int) -> int:
    """A child seed for ``(namespace, index)`` under ``base``.

    Distinct (namespace, index) pairs map to distinct streams with
    overwhelming probability (splitmix64 is a bijective mixer per input
    word), unlike affine offsets where two levels of derivation can land
    on the same integer.  Result fits in 63 bits."""
    h = _splitmix64((int(base) & _MASK64) ^ _splitmix64(((int(namespace) & _MASK64) << 20) ^ (int(index) & _MASK64)))
    return int(h & 0x7FFF_FFFF_FFFF_FFFF)
