"""TurboFSE group format + bit-exact host (numpy) twin (the v0 codec).

A copy of the JAX package's turbo/format.py; the tests hold it equal to
the original.  Its lane layout is also the TurboRANS byte wire's: on the
GPU lane k is thread k of a 1024-thread block (the encode and the flat
decodes) or thread l of row r's 128-thread block (the rows decode).

Wire layout of one group (all little-endian):

    header (16 B):
        u32 magic      0x183EF001
        u32 n_sym      true symbol count (group decodes to n_sym bytes)
        u32 csize_bits payload length in bits
        u8  table_log  (TURBO_TABLELOG, static per build)
        u8  flags      1 = raw payload (incompressible), 2 = RLE (1-byte payload)
        u16 ncount_len length in bytes of the NCount section
    ncount: reference-format normalized counts (FSE_writeNCount bytes,
        fse_compress.c:186-298), padded to a 4-byte boundary
    init_states: 1024 x u16, row-major [8][128] — the decoder's initial
        states (= encoder final states)
    payload: ceil(csize_bits/32) u32 words; bit i = word[i>>5] >> (i&31) & 1

Symbol <-> lane mapping (N = n_sym padded up to a multiple of 4096):
    lane k = r*128 + l handles bytes i = 4*(t4*1024 + k) + p at decode step
    t = 4*t4 + p.  Decode steps run t = 0..T-1 (T = N/1024); fields are read
    LIFO from bit position csize_bits downward, lanes ascending within a
    step; the last step consumes no bits (the encoder seeds those symbols
    with FSE_initCState2 semantics, lib/fse.h:500-512).  This mapping makes
    the decoder's per-step output tile [8,128] of packed u32 words land in
    ascending memory order with zero transposition.

Tables are the reference's exactly (same normalization fse_compress.c:316-494,
same spread fse_compress.c:108-122), so compression ratio matches the
reference per group; only the interleave and framing differ.
"""
from __future__ import annotations

import dataclasses
import struct

import numpy as np

from ..refimpl.hist import hist_count
from ..refimpl.ncount import fse_read_ncount, fse_write_ncount
from ..refimpl.norm import fse_normalize_count, fse_optimal_table_log
from ..refimpl.tables import build_ctable, build_dtable

TURBO_MAGIC = 0x183EF001
TURBO_LANES = 1024          # K: interleaved coder states per group
TURBO_STEP_SYMS = 4096      # symbols per supercycle (4 bytes per lane slot)
TURBO_TABLELOG = 11         # static; 2048 decode table entries
FLAG_RAW = 1
FLAG_RLE = 2

_HDR = struct.Struct("<IIIBBH")


def _pad_n(n: int) -> int:
    return (n + TURBO_STEP_SYMS - 1) // TURBO_STEP_SYMS * TURBO_STEP_SYMS


def _lane_view(src_pad: np.ndarray):
    """[N] bytes -> [T, 1024] symbol matrix in (decode step, lane) order.

    Byte i = 4*(t4*1024 + k) + p is handled by lane k at step 4*t4 + p:
    reshape to [T4, 1024, 4] then transpose the last two axes into steps.
    """
    t4 = src_pad.shape[0] // TURBO_STEP_SYMS
    m = src_pad.reshape(t4, TURBO_LANES, 4)
    return m.transpose(0, 2, 1).reshape(t4 * 4, TURBO_LANES)


def _unlane_view(sym_mat: np.ndarray) -> np.ndarray:
    t = sym_mat.shape[0]
    m = sym_mat.reshape(t // 4, 4, TURBO_LANES).transpose(0, 2, 1)
    return m.reshape(t * TURBO_LANES)


def _pack_bits_forward(vals: np.ndarray, nbs: np.ndarray) -> tuple[np.ndarray, int]:
    """Pack (val, nb) fields in order into LE u32 words. Returns (words, bits)."""
    nbs = nbs.astype(np.int64)
    offs = np.concatenate([[0], np.cumsum(nbs)[:-1]])
    total = int(offs[-1] + nbs[-1]) if len(nbs) else 0
    n_words = (total + 31) // 32
    words = np.zeros(n_words + 1, dtype=np.uint64)
    v = vals.astype(np.uint64) & ((np.uint64(1) << nbs.astype(np.uint64)) - np.uint64(1))
    w = (offs >> 5).astype(np.int64)
    sh = (offs & 31).astype(np.uint64)
    np.bitwise_or.at(words, w, (v << sh) & np.uint64(0xFFFFFFFF))
    # when sh == 0 the shift is 32 and v < 2^32, so the hi contribution is 0
    np.bitwise_or.at(words, w + 1, v >> (np.uint64(32) - sh))
    return words[:n_words].astype(np.uint32), total


def _read_fields(words: np.ndarray, offs: np.ndarray, nbs: np.ndarray) -> np.ndarray:
    """Vectorized field reads: offs/nbs arrays -> values (u32)."""
    w = (offs >> 5).astype(np.int64)
    sh = (offs & 31).astype(np.uint64)
    ext = np.concatenate([words.astype(np.uint64), np.zeros(2, np.uint64)])
    lo = ext[np.clip(w, 0, len(ext) - 1)] >> sh
    hi = np.where(sh == 0, np.uint64(0),
                  ext[np.clip(w + 1, 0, len(ext) - 1)] << (np.uint64(32) - sh))
    return ((lo | hi) & ((np.uint64(1) << nbs.astype(np.uint64)) - 1)).astype(np.uint32)


@dataclasses.dataclass
class TurboGroup:
    """Parsed group pieces (turbo/kernels.py stages these arrays)."""

    n_sym: int
    csize_bits: int
    table_log: int
    flags: int
    norm: np.ndarray | None      # int32[maxSV+1]
    max_symbol_value: int
    init_states: np.ndarray | None   # uint16[1024]
    payload: bytes               # raw payload bytes (words, LE)


def turbo_fse_compress(data: bytes) -> bytes:
    """Compress one group. RLE / raw fallbacks mirror fse_compress.c:653-655."""
    n = len(data)
    if n == 0:
        return _HDR.pack(TURBO_MAGIC, 0, 0, 0, FLAG_RAW, 0)
    src = np.frombuffer(data, dtype=np.uint8)
    count, max_sv, max_count = hist_count(src, 255)
    if max_count == n:  # RLE
        return _HDR.pack(TURBO_MAGIC, n, 8, 0, FLAG_RLE, 0) + bytes([src[0]]) + b"\0" * 3

    table_log = min(TURBO_TABLELOG, fse_optimal_table_log(TURBO_TABLELOG, n, max_sv))
    norm, table_log = fse_normalize_count(table_log, count[: max_sv + 1], n, max_sv)
    ncount = fse_write_ncount(norm, max_sv, table_log)
    ct = build_ctable(norm, max_sv, table_log)

    mfs = int(count.argmax())
    n_pad = _pad_n(n)
    src_pad = np.full(n_pad, mfs, dtype=np.uint8)
    src_pad[:n] = src
    syms = _lane_view(src_pad)           # [T, 1024]
    T = syms.shape[0]

    dnb = ct.delta_nb_bits.astype(np.int64)
    dfs = ct.delta_find_state.astype(np.int64)
    st = ct.state_table.astype(np.int64)

    # init from last decode step (FSE_initCState2: free first symbol per lane)
    s_last = syms[T - 1].astype(np.int64)
    nb0 = (dnb[s_last] + (1 << 15)) >> 16
    v0 = (nb0 << 16) - dnb[s_last]
    state = st[(v0 >> nb0) + dfs[s_last]]

    # encode steps t = T-2 .. 0; within a step lanes descend (reverse of the
    # decoder's ascending-lane LIFO reads)
    vals = np.zeros((T - 1, TURBO_LANES), dtype=np.uint32)
    nbs = np.zeros((T - 1, TURBO_LANES), dtype=np.int32)
    for t in range(T - 2, -1, -1):
        s = syms[t].astype(np.int64)
        nb = (state + dnb[s]) >> 16
        vals[t] = (state & ((1 << nb) - 1)).astype(np.uint32)
        nbs[t] = nb.astype(np.int32)
        state = st[(state >> nb) + dfs[s]]

    # forward emission order: t descending, lane descending
    emit_vals = vals[::-1, ::-1].reshape(-1)
    emit_nbs = nbs[::-1, ::-1].reshape(-1)
    words, csize_bits = _pack_bits_forward(emit_vals, emit_nbs)

    ncount_pad = ncount + b"\0" * (-len(ncount) % 4)
    # decoder state = table cell index = low tableLog bits of the coder value
    # (exactly what FSE_flushCState emits, lib/fse.h:523-527)
    init = (state & ((1 << table_log) - 1)).astype("<u2").tobytes()
    payload = words.astype("<u4").tobytes()
    out = (
        _HDR.pack(TURBO_MAGIC, n, csize_bits, table_log, 0, len(ncount))
        + ncount_pad + init + payload
    )
    if len(out) >= n + _HDR.size:  # incompressible
        return _HDR.pack(TURBO_MAGIC, n, 0, 0, FLAG_RAW, 0) + data
    return out


def parse_group(blob: bytes) -> tuple[TurboGroup, int]:
    """Parse one group; returns (group, bytes consumed)."""
    magic, n, csize_bits, table_log, flags, nc_len = _HDR.unpack_from(blob, 0)
    if magic != TURBO_MAGIC:
        raise ValueError("bad turbo magic")
    pos = _HDR.size
    if flags & FLAG_RAW:
        payload = blob[pos : pos + n]
        return TurboGroup(n, 0, 0, flags, None, 0, None, payload), pos + n
    if flags & FLAG_RLE:
        return TurboGroup(n, 8, 0, flags, None, 0, None, blob[pos : pos + 1]), pos + 4
    nc_pad = nc_len + (-nc_len % 4)
    # reader needs look-ahead slack past the NCount bytes (the reference
    # rejects exact-size buffers too); init_states provide it
    norm, max_sv, tlog, _used = fse_read_ncount(blob[pos : pos + nc_len + 8])
    assert tlog == table_log
    pos += nc_pad
    init = np.frombuffer(blob[pos : pos + 2 * TURBO_LANES], dtype="<u2").copy()
    pos += 2 * TURBO_LANES
    n_words = (csize_bits + 31) // 32
    payload = blob[pos : pos + 4 * n_words]
    pos += 4 * n_words
    return TurboGroup(n, csize_bits, table_log, flags,
                      np.asarray(norm, np.int32), max_sv, init, payload), pos


def turbo_fse_decompress(blob: bytes) -> bytes:
    """Host twin decode of one group (bit-exact model of the decode kernel)."""
    g, _ = parse_group(blob)
    if g.flags & FLAG_RAW:
        return bytes(g.payload)
    if g.flags & FLAG_RLE:
        return bytes([g.payload[0]]) * g.n_sym

    dt = build_dtable(g.norm, g.max_symbol_value, g.table_log)
    new_state = dt.new_state.astype(np.int64)
    symbol = dt.symbol.astype(np.uint8)
    nb_bits = dt.nb_bits.astype(np.int64)
    words = np.frombuffer(g.payload, dtype="<u4").astype(np.uint64)

    n_pad = _pad_n(g.n_sym)
    T = n_pad // TURBO_LANES
    state = g.init_states.astype(np.int64)
    out = np.zeros((T, TURBO_LANES), dtype=np.uint8)
    cursor = g.csize_bits
    for t in range(T - 1):
        nb = nb_bits[state]
        out[t] = symbol[state]
        prefix = np.cumsum(nb)
        offs = cursor - prefix
        bits = _read_fields(words, offs, nb)
        state = new_state[state] + bits
        cursor -= int(prefix[-1])
    if cursor != 0:
        raise ValueError("turbo stream corrupt: cursor %d after decode" % cursor)
    out[T - 1] = symbol[state]
    return _unlane_view(out)[: g.n_sym].tobytes()
