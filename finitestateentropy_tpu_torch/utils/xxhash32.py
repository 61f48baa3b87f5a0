"""XXH32 — needed for the frame checksum (reference programs/fileio.c:129,410-418).

The public XXH32 algorithm over a numpy view of the input; streaming state
not needed (frames are hashed in one shot over the original data).  The
port's copy runs the stripe loop on plain Python ints (same results as the
JAX package's numpy-scalar loop, several times faster).
"""
from __future__ import annotations

import numpy as np

_P1 = 2654435761
_P2 = 2246822519
_P3 = 3266489917
_P4 = 668265263
_P5 = 374761393
_M32 = 0xFFFFFFFF


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def xxh32(data: bytes | np.ndarray, seed: int = 0) -> int:
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    n = buf.size
    i = 0
    if n >= 16:
        nlanes = n // 16
        lanes = buf[: nlanes * 16].view("<u4").reshape(nlanes, 4)
        v = [
            (seed + _P1 + _P2) & _M32,
            (seed + _P2) & _M32,
            seed & _M32,
            (seed - _P1) & _M32,
        ]
        # per-lane sequential rounds (vector over the 4 lanes is what xxh
        # does; the stripe loop is inherently serial): plain Python ints over
        # each lane's column, several times faster than numpy scalars
        for k in range(4):
            acc = v[k]
            for x in lanes[:, k].tolist():
                acc = (acc + x * _P2) & _M32
                acc = (((acc << 13) | (acc >> 19)) * _P1) & _M32
            v[k] = acc
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12) + _rotl(v[3], 18)) & _M32
        i = nlanes * 16
    else:
        h = (seed + _P5) & _M32
    h = (h + n) & _M32
    while i + 4 <= n:
        w = int(buf[i]) | int(buf[i + 1]) << 8 | int(buf[i + 2]) << 16 | int(buf[i + 3]) << 24
        h = (h + w * _P3) & _M32
        h = (_rotl(h, 17) * _P4) & _M32
        i += 4
    while i < n:
        h = (h + int(buf[i]) * _P5) & _M32
        h = (_rotl(h, 11) * _P1) & _M32
        i += 1
    h ^= h >> 15
    h = (h * _P2) & _M32
    h ^= h >> 13
    h = (h * _P3) & _M32
    h ^= h >> 16
    return h
