"""XXH64 — the reference bundles both hashes (programs/xxhash.h:109-160);
XXH32 carries the frame CRC, XXH64 is used by the fuzzers/bench for
round-trip verification (programs/fuzzer.c, programs/bench.c).

Pure-python implementation of the public XXH64 algorithm, oracle-tested
against the reference's xxhash.c (tests/data_xxh_vectors.txt).
"""
from __future__ import annotations

import numpy as np

_P1 = 0x9E3779B185EBCA87
_P2 = 0xC2B2AE3D27D4EB4F
_P3 = 0x165667B19E3779F9
_P4 = 0x85EBCA77C2B2AE63
_P5 = 0x27D4EB2F165667C5
_M = (1 << 64) - 1


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M


def _round(acc: int, lane: int) -> int:
    acc = (acc + lane * _P2) & _M
    return (_rotl(acc, 31) * _P1) & _M


def _merge(acc: int, val: int) -> int:
    acc ^= _round(0, val)
    return (acc * _P1 + _P4) & _M


def xxh64(data: bytes | np.ndarray, seed: int = 0) -> int:
    b = np.asarray(bytearray(data), np.uint8).tobytes() \
        if not isinstance(data, bytes) else data
    n = len(b)
    pos = 0
    if n >= 32:
        v1 = (seed + _P1 + _P2) & _M
        v2 = (seed + _P2) & _M
        v3 = seed & _M
        v4 = (seed - _P1) & _M
        lanes = np.frombuffer(b[: n // 32 * 32], "<u8").reshape(-1, 4)
        for l1, l2, l3, l4 in lanes.tolist():
            v1 = _round(v1, l1)
            v2 = _round(v2, l2)
            v3 = _round(v3, l3)
            v4 = _round(v4, l4)
        pos = n // 32 * 32
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M
        h = _merge(h, v1)
        h = _merge(h, v2)
        h = _merge(h, v3)
        h = _merge(h, v4)
    else:
        h = (seed + _P5) & _M
    h = (h + n) & _M
    while pos + 8 <= n:
        h ^= _round(0, int.from_bytes(b[pos : pos + 8], "little"))
        h = (_rotl(h, 27) * _P1 + _P4) & _M
        pos += 8
    if pos + 4 <= n:
        h ^= (int.from_bytes(b[pos : pos + 4], "little") * _P1) & _M
        h = (_rotl(h, 23) * _P2 + _P3) & _M
        pos += 4
    while pos < n:
        h ^= (b[pos] * _P5) & _M
        h = (_rotl(h, 11) * _P1) & _M
        pos += 1
    h ^= h >> 33
    h = (h * _P2) & _M
    h ^= h >> 29
    h = (h * _P3) & _M
    h ^= h >> 32
    return h
