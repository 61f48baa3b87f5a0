"""Pure-numpy helpers that live in jax-importing modules of the JAX package.

Copies of finitestateentropy_tpu/turbo/rans_kernels.py:242-256 (stream
words), :783-793 (_enc_chunking), :886-905 (byte-wire table packers) and
:1182-1214 (the resident decoder's interleave pick, which the decode
routing in api.py reads).  The tests hold each equal to its original.
"""
from __future__ import annotations

import numpy as np

from .rans import RANS_TABLELOG, rans_decode_table, rans_freqs


def stream_word_rows(hrows: int) -> int:
    """Packed-stream row count for a given halfword-row geometry: the wire
    payload packs 2 LE halfwords per i32 word (the kernels' native layout;
    the payload BYTES are exactly these words little-endian)."""
    return ((hrows + 1) // 2 + 8 + 7) // 8 * 8


def pack_stream_words(payload: bytes, srows: int) -> np.ndarray:
    """Stage a wire payload into the packed [srows,128] i32 word layout the
    decode kernels consume — a pure numpy view, no per-halfword work."""
    out = np.zeros(srows * 128, np.int32)
    w = np.frombuffer(payload + b"\0" * (-len(payload) % 4), "<u4")
    out[: len(w)] = w.view(np.int32)
    return out.reshape(srows, 128)


def _enc_chunking(t4_count: int, spc: int) -> tuple[int, int]:
    """(chunk_t4, n_chunks): the JAX encoder chunks src reads when a group
    exceeds 1 MiB of supercycles.  The CUDA encoder runs one loop over all
    steps, but the rule shapes which group sizes are legal, so it stays.
    (The original's force_chunk, a test hook for interpret mode, is not
    copied.)"""
    max_chunk = 256                           # ~1 MiB of src per chunk
    if t4_count <= max_chunk:
        return t4_count, 1
    if t4_count % max_chunk:
        raise ValueError(
            f"large groups must be a multiple of {max_chunk} supercycles; "
            f"got t4_count={t4_count} (pad or split the tail group)")
    return max_chunk, t4_count // max_chunk


def pack_rans_dtable(norm, tlog: int = RANS_TABLELOG) -> np.ndarray:
    """[tchunks,128] i32 decode table for the kernel."""
    t = rans_decode_table(norm, tlog)
    n = max(1 << tlog, 128)
    out = np.zeros(n, np.int32)
    out[: len(t)] = t
    return out.reshape(n // 128, 128)


def pack_rans_ctables(norm) -> tuple[np.ndarray, np.ndarray]:
    """((cumul<<12)|freq)[2,128], magic[2,128] — 256-symbol encode tables."""
    freq, cumul = rans_freqs(np.asarray(norm))
    f = np.zeros(256, np.int64)
    c = np.zeros(256, np.int64)
    f[: len(freq)] = freq
    c[: len(cumul)] = cumul
    f = np.maximum(f, 1)  # unused symbols: avoid div-by-zero magic
    fc = ((c << 12) | f).astype(np.int32)
    magic = np.minimum(2**32 // f, 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    return fc.reshape(2, 128), magic.reshape(2, 128)


def _pick_nway(per_group_bytes: int, budget: int = (18 * 2**20 + 700 * 2**10)) -> int:
    """Widest interleave whose double-buffered blocks fit the JAX resident
    decoder's VMEM budget.  The GPU has no such budget; the port keeps the
    rule because the decode routing (api._window_dispatch) reads it."""
    for nway in (7, 6, 5, 4, 3, 2):
        if 2 * nway * per_group_bytes < budget:
            return nway
    return 1


def v2_pick_nway(t4_count: int, hrows: int, tlog: int = RANS_TABLELOG) -> int:
    """The interleave width the JAX rans_decode_v2 would pick for a
    byte-wire shape: the routing between the rans_decode_v2 and
    rans_decode_w entries compares it against the windowed kernel's
    padding waste."""
    T = t4_count * 4
    rows_per = t4_count * 8 + 8
    tch = max((1 << tlog) // 128, 1)
    r8 = ((T + 127) // 128) * 8
    rc = ((t4_count + 7) // 8) * 8
    srows = stream_word_rows(hrows)
    per_group = (srows + rows_per + rc + r8 + tch + 8) * 512
    return _pick_nway(per_group)
