"""Pure-numpy helpers that live in jax-importing modules of the JAX package.

Copies of finitestateentropy_tpu/turbo/rans_kernels.py:242-256 (stream
words), :783-793 (_enc_chunking), :886-929 (byte-wire and U16 table
packers), :932-1007 (pair, quad and wide-U16 tables) and :1182-1214 (the
resident decoder's interleave pick, which the decode routing in api.py
reads).  The tests hold each equal to its original.  tch_of, the port's
own, gives each mode's decode table height to the staging and the
wrappers' shape checks.
"""
from __future__ import annotations

import numpy as np

from .rans import RANS_TABLELOG, rans_decode_table, rans_freqs
from .rans16 import rans16_decode_table


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


def _enc_chunking(t4_count: int, spc: int, force_chunk: int = 0) -> tuple[int, int]:
    """(chunk_t4, n_chunks): the JAX encoder chunks src reads when a group
    exceeds 1 MiB of supercycles.  The CUDA encoder runs one loop over all
    steps, but the rule shapes which group sizes are legal, so it stays.
    force_chunk (tests only) shrinks the chunk span; it changes no output,
    but a group that does not fit the span still raises."""
    max_chunk = force_chunk or 256            # ~1 MiB of src per chunk
    if t4_count <= max_chunk:
        return t4_count, 1
    if t4_count % max_chunk:
        raise ValueError(
            f"large groups must be a multiple of {max_chunk} supercycles; "
            f"got t4_count={t4_count} (pad or split the tail group)")
    return max_chunk, t4_count // max_chunk


def tch_of(mode: str, tlog: int) -> int:
    """Rows of 128 words in a decode table of a wire mode at tableLog tlog:
    the 2^tlog entries (twice that for u16x's symbol plane), plus the two
    rows of the 256-entry id LUT on the pair and quad wires."""
    return (max((1 << tlog) // 128, 1) * (2 if mode == "u16x" else 1)
            + (2 if mode in ("pair", "quad") else 0))


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


def pack_rans16_dtable(norm, tlog: int = RANS_TABLELOG) -> np.ndarray:
    """[2^tlog/128,128] i32 u16 decode table ((cumul<<21)|(freq<<10)|sym)."""
    t = rans16_decode_table(norm, tlog)
    n = max(1 << tlog, 128)
    out = np.zeros(n, np.int32)
    out[: len(t)] = t
    return out.reshape(n // 128, 128)


def pack_rans16_ctables(norm) -> tuple[np.ndarray, np.ndarray]:
    """((cumul<<12)|freq)[8,128], magic[8,128] — 1024-symbol encode tables."""
    freq, cumul = rans_freqs(np.asarray(norm))
    f = np.ones(1024, np.int64)
    c = np.zeros(1024, np.int64)
    f[: len(freq)] = freq
    c[: len(cumul)] = cumul
    f = np.maximum(f, 1)
    fc = ((c << 12) | f).astype(np.int32)
    magic = np.minimum(2**32 // f, 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    return fc.reshape(8, 128), magic.reshape(8, 128)


def pack_pair_dtable(norm, pairs: np.ndarray,
                     tlog: int = RANS_TABLELOG) -> np.ndarray:
    """[(2^tlog/128)+2, 128] i32 pair-wire decode table (turbo/pair.py):
    rows [0, tch) pack (pair_id << 2*tlog) | (freq << tlog) | (slot-cumul)
    — one word since pair_id < 256 and tlog <= 12 — and rows [tch, tch+2)
    hold the 256-entry id -> raw u16 pair-value LUT."""
    assert tlog <= 12, tlog
    freq, cumul = rans_freqs(np.asarray(norm))
    m = 1 << tlog
    tch = max(m // 128, 1)
    bounds = np.concatenate([cumul, [m]])
    slots = np.arange(m)
    sid = np.searchsorted(bounds, slots, side="right") - 1
    e = ((sid << (2 * tlog)) | (freq[sid] << tlog)
         | (slots - cumul[sid])).astype(np.int64)
    main = np.zeros(max(m, 128), np.int64)
    main[:m] = e
    lut = np.zeros(256, np.int32)
    lut[: len(pairs)] = np.asarray(pairs, np.uint16)
    return np.concatenate(
        [main.astype(np.int32).reshape(-1, 128), lut.reshape(2, 128)], axis=0)


def pack_quad_dtable(norm, quads: np.ndarray,
                     tlog: int = RANS_TABLELOG) -> np.ndarray:
    """[(2^tlog/128)+2, 128] i32 quad-wire decode table (turbo/quad.py):
    identical layout to pack_pair_dtable but the 256-entry LUT in rows
    [tch, tch+2) holds raw u32 4-byte groups (stored as i32 bit patterns
    — the decode step's output word IS the LUT value)."""
    assert tlog <= 12, tlog
    freq, cumul = rans_freqs(np.asarray(norm))
    m = 1 << tlog
    tch = max(m // 128, 1)
    bounds = np.concatenate([cumul, [m]])
    slots = np.arange(m)
    sid = np.searchsorted(bounds, slots, side="right") - 1
    e = ((sid << (2 * tlog)) | (freq[sid] << tlog)
         | (slots - cumul[sid])).astype(np.int64)
    main = np.zeros(max(m, 128), np.int64)
    main[:m] = e
    lut = np.zeros(256, "<u4")
    lut[: len(quads)] = np.asarray(quads, np.uint32)
    return np.concatenate(
        [main.astype(np.int32).reshape(-1, 128),
         lut.view(np.int32).reshape(2, 128)], axis=0)


def pack_rans16x_dtable(norm, tlog: int) -> np.ndarray:
    """[2*(2^tlog/128),128] i32 split decode table for symbols up to 4095:
    rows [0, tch) hold e1 = (freq << 13) | (slot - cumul), rows [tch, 2tch)
    the 12-bit symbol (the fields don't fit one 32-bit entry; alphabets
    above 1023 also need tableLog 12-13, fseU16.c:43-48)."""
    freq, cumul = rans_freqs(np.asarray(norm))
    m = 1 << tlog
    tch = m // 128
    bounds = np.concatenate([cumul, [m]])
    slots = np.arange(m)
    sym = np.searchsorted(bounds, slots, side="right") - 1
    j = slots - cumul[sym]
    e1 = ((freq[sym] << 13) | j).astype(np.int32)
    return np.concatenate(
        [e1.reshape(tch, 128), sym.astype(np.int32).reshape(tch, 128)], axis=0)


def pack_rans16x_ctables(norm) -> tuple[np.ndarray, np.ndarray]:
    """((cumul<<14)|freq)[32,128], magic[32,128] — 4096-symbol encode
    tables; 14-bit fields fit tableLog up to 13 (freq/cumul < 2^14)."""
    freq, cumul = rans_freqs(np.asarray(norm))
    f = np.ones(4096, np.int64)
    c = np.zeros(4096, np.int64)
    f[: len(freq)] = freq
    c[: len(cumul)] = cumul
    f = np.maximum(f, 1)
    fc = ((c << 14) | f).astype(np.int32)
    magic = np.minimum(2**32 // f, 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    return fc.reshape(32, 128), magic.reshape(32, 128)


def _pick_nway(per_group_bytes: int, budget: int = (18 * 2**20 + 700 * 2**10)) -> int:
    """Widest interleave whose double-buffered blocks fit the JAX resident
    decoder's VMEM budget.  The GPU has no such budget; the port keeps the
    rule because the decode routing (api._window_dispatch) reads it."""
    for nway in (7, 6, 5, 4, 3, 2):
        if 2 * nway * per_group_bytes < budget:
            return nway
    return 1


def v2_pick_nway(t4_count: int, hrows: int, tlog: int = RANS_TABLELOG,
                 u16: bool = False, totals_only: bool = False,
                 u16x: bool = False, pair: bool = False,
                 quad: bool = False) -> int:
    """The interleave width the JAX rans_decode_v2 would pick for this
    shape: the routing between the rans_decode_v2 and rans_decode_w
    entries (api._window_dispatch) compares it against the windowed
    kernel's padding waste."""
    spc = 1 if quad else 2 if u16 else 4
    T = t4_count * spc
    rows_per = t4_count * 8 + 8
    tch = (max((1 << tlog) // 128, 1) * (2 if u16x else 1)
           + (2 if pair or quad else 0))
    r8 = 0 if totals_only else ((T + 127) // 128) * 8
    rc = ((t4_count + 7) // 8) * 8
    srows = stream_word_rows(hrows)
    per_group = (srows + rows_per + rc + r8 + tch + 8) * 512
    return _pick_nway(per_group)
