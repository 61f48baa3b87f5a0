"""Exact twin of the reference corpus generator (programs/probaGenerator.c).

The benchmark corpora Proba80/Proba14/Proba02 are defined by this generator:
a 4096-slot symbol table filled by geometric decay (each next symbol receives
``max(1, remaining*p)`` slots, probaGenerator.c:109-118) sampled with the LCG
``seed = seed*2654435761 + 2246822519; out = seed >> 11`` (:70-74).  Output
must match the C binary byte-for-byte so benchmark ratios are comparable.
"""
from __future__ import annotations

import numpy as np

_PRIME1 = 2654435761
_PRIME2 = 2246822519
_TABLE_SIZE = 4096
BUFFER_SIZE = (1 << 20) - 1  # probaGenerator.c:47


def _build_table(p: float) -> np.ndarray:
    table = np.zeros(_TABLE_SIZE, dtype=np.uint8)
    remaining = _TABLE_SIZE
    pos = 0
    s = 0
    while remaining:
        n = int(remaining * p)
        if n == 0:
            n = 1
        table[pos : pos + n] = s & 0xFF
        pos += n
        s += 1
        remaining -= n
    return table


def _lcg_stream(count: int, seed: int = 1) -> np.ndarray:
    """Vectorized LCG: computes seed_i for i in [1..count] via log-doubling.

    seed_{i+1} = seed_i * P1 + P2 (mod 2^32).  Affine maps compose, so the
    sequence is generated in O(count) numpy work instead of a Python loop.
    """
    # affine composition: x -> a*x + b
    out = np.empty(count, dtype=np.uint64)
    # block-wise: precompute (a^k, b_k) for k = 1..B then jump by B
    B = 65536
    a_pows = np.empty(B + 1, dtype=np.uint64)
    b_offs = np.empty(B + 1, dtype=np.uint64)
    a_pows[0] = 1
    b_offs[0] = 0
    M = np.uint64(0xFFFFFFFF)
    for k in range(1, B + 1):
        a_pows[k] = (a_pows[k - 1] * np.uint64(_PRIME1)) & M
        b_offs[k] = (b_offs[k - 1] * np.uint64(_PRIME1) + np.uint64(_PRIME2)) & M
    pos = 0
    x = np.uint64(seed)
    while pos < count:
        m = min(B, count - pos)
        out[pos : pos + m] = (a_pows[1 : m + 1] * x + b_offs[1 : m + 1]) & M
        x = out[pos + m - 1]
        pos += m
    return out


def make_proba_buffer(p: float, size: int = BUFFER_SIZE) -> bytes:
    if p == 0.0:
        p = 0.005
    table = _build_table(p)
    seeds = _lcg_stream(size)
    idx = (seeds >> np.uint64(11)).astype(np.uint32) & (_TABLE_SIZE - 1)
    return table[idx].tobytes()


def generate_proba(percent: int, size: int = BUFFER_SIZE) -> bytes:
    """generate_proba(80) == the Proba80 corpus (``probagen 80%``)."""
    return make_proba_buffer(percent / 100.0, size)
