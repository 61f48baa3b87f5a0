"""A pool of input buffers drawn from the reference's benchmark corpora.

The corpora are those of the reference's probaGenerator.c: a 4096-slot
table filled by geometric decay (each next symbol takes max(1, remaining *
p) slots) and sampled by the LCG seed = seed * 2654435761 + 2246822519
(mod 2^32), slot = (seed >> 11) & 4095.  With LCG seed 1 this is the
reference's own output; here each stream takes its LCG seed from the run's
seed.

Parameters (the traffic file): percent (p = percent / 100, 0 as 0.005),
call_bytes (one call's input), pool (distinct buffers), streams (streams
generated), stream_bytes (each stream's length).  Buffer i takes stream i %
streams: the stream's k-th cut of call_bytes for k = i // streams while
whole cuts remain, then cuts of the stream rotated by an offset drawn from
the seed, so that a few generated streams give many distinct buffers.
"""
from __future__ import annotations

import numpy as np

PRIME1 = 2654435761
PRIME2 = 2246822519
TABLE_SIZE = 4096
M32 = np.uint64(0xFFFFFFFF)
BLOCK = 1 << 16


def symbol_table(p: float) -> np.ndarray:
    table = np.zeros(TABLE_SIZE, np.uint8)
    remaining, pos, s = TABLE_SIZE, 0, 0
    while remaining:
        n = max(int(remaining * p), 1)
        table[pos:pos + n] = s & 0xFF
        pos += n
        s += 1
        remaining -= n
    return table


def _affine_powers() -> tuple[np.ndarray, np.ndarray]:
    """(a_k, b_k) for k = 0..BLOCK: k LCG steps as x -> a_k x + b_k."""
    a = np.array([1, PRIME1], np.uint64)
    b = np.array([0, PRIME2], np.uint64)
    while len(a) <= BLOCK:       # steps L+j = j steps after L steps
        L = len(a) - 1
        a = np.concatenate([a, (a[1:] * a[L]) & M32])
        b = np.concatenate([b, (a[1:L + 1] * b[L] + b[1:]) & M32])
    return a[:BLOCK + 1], b[:BLOCK + 1]


def proba_stream(percent: float, size: int, lcg_seed: int = 1) -> np.ndarray:
    """size bytes of probaGenerator's corpus at percent, from lcg_seed."""
    p = percent / 100.0 or 0.005
    table = symbol_table(p)
    a, b = _affine_powers()
    out = np.empty(size, np.uint8)
    x = np.uint64(lcg_seed & 0xFFFFFFFF)
    for pos in range(0, size, BLOCK):
        m = min(BLOCK, size - pos)
        seeds = (a[1:m + 1] * x + b[1:m + 1]) & M32
        out[pos:pos + m] = table[(seeds >> np.uint64(11)) & np.uint64(TABLE_SIZE - 1)]
        x = seeds[m - 1]
    return out


def make_pool(params: dict, seed: int) -> list[np.ndarray]:
    """The traffic's buffers (uint8 arrays), the same for the same seed."""
    rng = np.random.default_rng(seed)
    call, size = params["call_bytes"], params["stream_bytes"]
    n_streams, pool = params["streams"], params["pool"]
    cuts = size // call
    if cuts < 1:
        raise ValueError("call_bytes exceeds stream_bytes")
    lcg = rng.integers(1, 1 << 32, size=n_streams)
    streams = [proba_stream(params["percent"], size, int(s)) for s in lcg]
    out = []
    for i in range(pool):
        src, k = streams[i % n_streams], i // n_streams
        if k >= cuts:
            src = np.roll(src, -int(rng.integers(1, size)))
        k %= cuts
        out.append(np.ascontiguousarray(src[k * call:(k + 1) * call]))
    return out
