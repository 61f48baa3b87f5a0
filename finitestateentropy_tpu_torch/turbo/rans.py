"""TurboRANS — lane-interleaved rANS group format + bit-exact host twin.

Same interleave philosophy as TurboFSE (format.py) but the coder is rANS
with 16-bit renormalization: each of the 1024 lanes emits 0 or 1 aligned
halfwords per step, so both encode and decode are single-gather kernels
(no bit-granular packing).  Frequencies come from the reference's exact
normalization (fse_compress.c:316-494) serialized with the reference NCount
codec, so compression ratio matches the FSE reference per group
(norm == -1 low-prob symbols map to freq 1, as in fse_decompress.c:86-99).

Wire layout of one group (little-endian):

    header (16 B):  u32 magic 0x183EF002 | u32 n_sym | u32 csize_hw
                    u8 table_log | u8 flags(1=raw,2=rle) | u16 ncount_len
    ncount:         reference FSE_writeNCount bytes, padded to 4B
    init_states:    1024 x u32 row-major [8][128] (decoder initial states
                    = encoder final states)
    payload:        csize_hw x u16 halfwords

Coder math (per lane; x is u32, L = 2^16, M = 2^table_log):
    decode: slot = x & (M-1); (sym, f, c) = tbl[slot]
            x = f * (x >> tlog) + slot - c
            if x < L: x = (x << 16) | next_halfword     (cursor descends)
    encode (reverse order):
            if x >= f << (32 - tlog): emit low 16 bits; x >>= 16
            x = (x // f) << tlog | (c + x % f)
    Encoder starts every lane at x = L (early symbols emit nothing — the
    free-first-symbol property, analogous to FSE_initCState2); the decoder's
    final state must return to exactly L, which doubles as the per-lane
    corruption check.

Halfword layout: at decode step t, flagged lanes (ascending k) read
positions cursor - rank_k (rank = inclusive prefix of flags); cursor -=
total.  The encoder mirrors this exactly (see twin below).

Copy of the JAX package's turbo/rans.py:47-330 (byte wire only: pair and
quad groups raise NotImplementedError); the tests hold it equal to the
original.  The numpy twin rans_compress / rans_decompress is the port's
own oracle, so checks on the GPU need no JAX.
"""
from __future__ import annotations

import struct

import numpy as np

from ..refimpl.hist import hist_count
from ..refimpl.ncount import fse_read_ncount, fse_write_ncount
from ..refimpl.norm import fse_normalize_count, fse_optimal_table_log
from .format import TURBO_LANES, TURBO_STEP_SYMS, _lane_view, _pad_n, _unlane_view

RANS_MAGIC = 0x183EF002
RANS_TABLELOG = 11        # ratio-mode default (reference-parity tables)
RANS_SPEED_TABLELOG = 10  # speed-mode default: 8-chunk lookups decode ~30%
                          # faster for ~0.1% ratio (PERFORMANCE.md r2 sweep)
RANS_L = 1 << 16
FLAG_RAW = 1
FLAG_RLE = 2
FLAG_STEPTOTS = 4   # v2: per-step per-ROW renorm counts (8 u8/step)
FLAG_TOTALS = 8     # v3: per-step renorm TOTALS only (1 u16/step) — the
                    # decoder recomputes row offsets with one extra matmul;
                    # 4x smaller section, same cursor precomputation
FLAG_ROWS4 = 16     # modifier on FLAG_STEPTOTS: counts nibble-packed
                    # (2 steps/byte) + an escape table for counts >= 15 —
                    # the section halves with NO decode-speed cost (the
                    # kernels consume unpacked [T,8] arrays either way).
                    # Picked automatically whenever it is smaller.
FLAG_PAIR = 32      # order-1 pair wire (not in the port yet)
FLAG_QUAD = 128     # order-3 quad wire (not in the port yet)

_HDR = struct.Struct("<IIIBBH")


def _pack_rows4(tots: np.ndarray) -> bytes | None:
    """[T,8] u8 row counts -> FLAG_ROWS4 section bytes, or None when the
    escape table would make it no smaller than the plain 8 B/step wire.

    Layout: u32 n_exc | n_exc x (u16 step, u8 row, u8 count) | T*4 nibble
    bytes (step pair 2t|2t+1 -> low|high nibble, 8 rows each).  Nibble 15
    is an escape marker: the true count lives in the exception table."""
    T = tots.shape[0]
    exc = np.argwhere(tots >= 15)
    if 4 + 4 * len(exc) >= 4 * T:
        return None
    nib = np.minimum(tots, 15).astype(np.uint8)
    if T % 2:
        # odd step counts (quad wire: groups pad to 1024 ids, so T can be
        # odd) pack a zero high-nibble row; without this the numpy |
        # silently BROADCAST (T//2+1, 8) | (T//2, 8) rows — corrupt wire
        nib = np.concatenate([nib, np.zeros((1, 8), np.uint8)])
    packed = (nib[0::2] | (nib[1::2] << 4)).reshape(-1)
    out = struct.pack("<I", len(exc))
    if len(exc):
        e = np.zeros((len(exc), 4), np.uint8)
        e[:, :2] = exc[:, 0].astype("<u2").view(np.uint8).reshape(-1, 2)
        e[:, 2] = exc[:, 1]
        e[:, 3] = tots[exc[:, 0], exc[:, 1]]
        out += e.tobytes()
    return out + packed.tobytes()


def _unpack_rows4(buf: bytes, T: int) -> tuple[np.ndarray, int]:
    """FLAG_ROWS4 section -> ([T,8] u8 counts, bytes consumed).

    Corrupt sections (truncated, out-of-range escape coordinates) raise
    ValueError — garbage input must never index out of bounds (the fuzz
    suite feeds arbitrary bytes here)."""
    if len(buf) < 4:
        raise ValueError("turbo-rans rows4 section truncated")
    (n_exc,) = struct.unpack_from("<I", buf, 0)
    pos = 4 + 4 * n_exc
    Tp = T + (T & 1)                  # odd T ships a zero-padded row
    if n_exc > T * 8 or len(buf) < pos + Tp * 4:
        raise ValueError("turbo-rans rows4 section corrupt")
    packed = np.frombuffer(buf[pos : pos + Tp * 4], np.uint8).reshape(Tp // 2, 8)
    tots = np.zeros((Tp, 8), np.uint8)
    tots[0::2] = packed & 15
    tots[1::2] = packed >> 4
    tots = tots[:T]
    if n_exc:
        e = np.frombuffer(buf[4:pos], np.uint8).reshape(n_exc, 4)
        steps = e[:, :2].copy().view("<u2").reshape(-1)
        if (steps >= T).any() or (e[:, 2] >= 8).any():
            raise ValueError("turbo-rans rows4 escape out of range")
        tots[steps, e[:, 2]] = e[:, 3]
    return tots, pos + Tp * 4


def rans_freqs(norm: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """norm (reference normalized counts, -1 = low prob) -> (freq, cumul)."""
    freq = np.where(np.asarray(norm) == -1, 1, np.asarray(norm)).astype(np.int64)
    cumul = np.concatenate([[0], np.cumsum(freq)[:-1]])
    return freq, cumul


def rans_decode_table(norm: np.ndarray, table_log: int) -> np.ndarray:
    """slot -> packed i32 entry: (cumul << 20) | (freq << 8) | sym."""
    freq, cumul = rans_freqs(norm)
    m = 1 << table_log
    bounds = np.concatenate([cumul, [m]])
    slots = np.arange(m)
    sym = np.searchsorted(bounds, slots, side="right") - 1
    e = (cumul[sym] << 20) | (freq[sym] << 8) | sym
    return e.astype(np.int64).astype(np.uint32).view(np.int32)


def rans_compress(data: bytes, table_log: int = 0,
                  steptots: bool = True, totals_only: bool = False) -> bytes:
    """steptots=True emits the speed-mode section.  totals_only picks the
    wire: False (default) ships 8 u8 row counts per step (FLAG_STEPTOTS) —
    the fastest decode (rank folds into ONE fused matmul); True ships 1 u16
    total per step (FLAG_TOTALS) — 4x smaller section, but the decoder must
    recompute row offsets with two chained matmuls on the serial path
    (~0.4x decode speed; the middle ratio/speed mode).

    table_log=0 picks the mode default: RANS_SPEED_TABLELOG (10) with a
    speed section, RANS_TABLELOG (11) in ratio mode."""
    if table_log == 0:
        table_log = RANS_SPEED_TABLELOG if steptots else RANS_TABLELOG
    n = len(data)
    if n == 0:
        return _HDR.pack(RANS_MAGIC, 0, 0, 0, FLAG_RAW, 0)
    src = np.frombuffer(data, dtype=np.uint8)
    count, max_sv, max_count = hist_count(src, 255)
    if max_count == n:
        return _HDR.pack(RANS_MAGIC, n, 0, 0, FLAG_RLE, 0) + bytes([src[0]]) + b"\0" * 3
    if max_count <= (n >> 7):
        # near-uniform data is not compressible: the reference's heuristic
        # (fse_compress.c:653-655) applied before paying for the encode —
        # the raw fallback after encoding would pick the same bytes
        return _HDR.pack(RANS_MAGIC, n, 0, 0, FLAG_RAW, 0) + data

    table_log = min(table_log, fse_optimal_table_log(table_log, n, max_sv))
    norm, table_log = fse_normalize_count(table_log, count[: max_sv + 1], n, max_sv)
    ncount = fse_write_ncount(norm, max_sv, table_log)
    freq, cumul = rans_freqs(np.asarray(norm))
    fr = np.zeros(256, np.int64)
    cu = np.zeros(256, np.int64)
    fr[: len(freq)] = freq
    cu[: len(cumul)] = cumul

    mfs = int(count.argmax())
    n_pad = _pad_n(n)
    src_pad = np.full(n_pad, mfs, dtype=np.uint8)
    src_pad[:n] = src
    syms = _lane_view(src_pad)  # [T, 1024]
    T = syms.shape[0]

    x = np.full(TURBO_LANES, RANS_L, dtype=np.uint64)
    chunks: list[np.ndarray] = []
    tots = np.zeros((T, 8), dtype=np.uint8)       # v2 section (decode order)
    thresh_shift = 32 - table_log
    for t in range(T - 1, -1, -1):
        s = syms[t].astype(np.int64)
        f = fr[s].astype(np.uint64)
        c = cu[s].astype(np.uint64)
        flag = x >= (f << np.uint64(thresh_shift))
        tots[t] = flag.reshape(8, 128).sum(axis=1).astype(np.uint8)
        if flag.any():
            vals = (x[flag] & np.uint64(0xFFFF)).astype(np.uint16)
            # decode reads rank-1 lane at the highest position: positions
            # within this step descend as lane index ascends, and the stream
            # grows upward, so append flagged-lane values reversed
            chunks.append(vals[::-1])
            x = np.where(flag, x >> np.uint64(16), x)
        q = x // f
        r = x - q * f
        x = (q << np.uint64(table_log)) + c + r
    # encode order (t = T-1 first) already writes ascending positions: the
    # decoder's cursor descends, so its first-read block is the last-encoded
    stream = np.concatenate(chunks) if chunks else np.zeros(0, np.uint16)
    csize_hw = len(stream)

    ncount_pad = ncount + b"\0" * (-len(ncount) % 4)
    init = x.astype("<u4").tobytes()
    if steptots and totals_only:
        # T is a multiple of 4, so T*2 bytes is 4B-aligned
        sect = tots.astype(np.uint16).sum(axis=1).astype("<u2").tobytes()
        flags_out = FLAG_TOTALS
    elif steptots:
        packed = _pack_rows4(tots)
        if packed is not None:
            sect = packed
            flags_out = FLAG_STEPTOTS | FLAG_ROWS4
        else:
            # T*8 is 4B-aligned
            sect = tots.reshape(-1).tobytes()
            flags_out = FLAG_STEPTOTS
    else:
        sect = b""
        flags_out = 0
    out = (
        _HDR.pack(RANS_MAGIC, n, csize_hw, table_log, flags_out, len(ncount))
        + ncount_pad + init + sect + stream.astype("<u2").tobytes()
    )
    if len(out) >= n + _HDR.size:
        return _HDR.pack(RANS_MAGIC, n, 0, 0, FLAG_RAW, 0) + data
    return out


def parse_rans_group(blob: bytes):
    magic, n, csize_hw, table_log, flags, nc_len = _HDR.unpack_from(blob, 0)
    if magic != RANS_MAGIC:
        raise ValueError("bad turbo-rans magic")
    if flags & FLAG_PAIR:
        raise NotImplementedError(
            "pair-wire groups (FLAG_PAIR) arrive with ROADMAP.md queue A "
            "item 4 (pair wire)")
    if flags & FLAG_QUAD:
        raise NotImplementedError(
            "quad-wire groups (FLAG_QUAD) arrive with ROADMAP.md queue A "
            "item 3 (quad wire)")
    pos = _HDR.size
    if flags & FLAG_RAW:
        return (n, csize_hw, table_log, flags, None, 0, None,
                blob[pos : pos + n], None), pos + n
    if flags & FLAG_RLE:
        return (n, 0, 0, flags, None, 0, None, blob[pos : pos + 1], None), pos + 4
    # the reference reader needs look-ahead slack beyond the NCount bytes
    # (entropy_common.c reads 4-byte words; an exact-size buffer is rejected
    # even by the reference) — the init_states section provides it
    norm, max_sv, tlog, used = fse_read_ncount(blob[pos : pos + nc_len + 8])
    assert tlog == table_log and used <= nc_len + 1
    pos += nc_len + (-nc_len % 4)
    init = np.frombuffer(blob[pos : pos + 4 * TURBO_LANES], dtype="<u4").copy()
    pos += 4 * TURBO_LANES
    steptots = None
    if flags & FLAG_STEPTOTS:
        T = _pad_n(n) // TURBO_LANES
        if flags & FLAG_ROWS4:
            steptots, used = _unpack_rows4(blob[pos:], T)
            pos += used
        else:
            steptots = np.frombuffer(blob[pos : pos + T * 8],
                                     np.uint8).reshape(T, 8).copy()
            pos += T * 8
    elif flags & FLAG_TOTALS:
        # v3 section: 1-D totals array (callers distinguish by ndim)
        T = _pad_n(n) // TURBO_LANES
        steptots = np.frombuffer(blob[pos : pos + T * 2], "<u2").astype(np.int32)
        pos += T * 2
    payload = blob[pos : pos + 2 * csize_hw]
    pos += 2 * csize_hw
    return (n, csize_hw, table_log, flags, np.asarray(norm, np.int32), max_sv,
            init, payload, steptots), pos


def rans_decompress(blob: bytes) -> bytes:
    g, _ = parse_rans_group(blob)
    (n, csize_hw, table_log, flags, norm, max_sv, init, payload,
     steptots) = g
    if flags & FLAG_RAW:
        return bytes(payload)
    if flags & FLAG_RLE:
        return bytes([payload[0]]) * n

    tbl = rans_decode_table(norm, table_log).view(np.uint32).astype(np.uint64)
    hw = np.frombuffer(payload, dtype="<u2").astype(np.uint64)
    m_mask = np.uint64((1 << table_log) - 1)

    n_pad = _pad_n(n)
    T = n_pad // TURBO_LANES
    x = init.astype(np.uint64)
    out = np.zeros((T, TURBO_LANES), dtype=np.uint8)
    cursor = csize_hw
    for t in range(T):
        slot = x & m_mask
        e = tbl[slot]
        out[t] = (e & np.uint64(0xFF)).astype(np.uint8)
        f = (e >> np.uint64(8)) & np.uint64(0xFFF)
        c = e >> np.uint64(20)
        x = f * (x >> np.uint64(table_log)) + slot - c
        flag = x < np.uint64(RANS_L)
        if steptots is not None:
            rows = flag.reshape(8, 128).sum(axis=1)
            bad = (int(rows.sum()) != int(steptots[t])
                   if steptots.ndim == 1
                   else not np.array_equal(rows, steptots[t]))
            if bad:
                raise ValueError("turbo-rans stream corrupt (steptots)")
        rank = np.cumsum(flag)
        pos = cursor - rank
        v = (hw[np.clip(pos, 0, max(len(hw) - 1, 0))] if len(hw)
             else np.zeros(len(pos), np.uint64))
        x = np.where(flag, (x << np.uint64(16)) | v, x)
        cursor -= int(rank[-1])
    if cursor != 0 or not (x == RANS_L).all():
        raise ValueError("turbo-rans stream corrupt")
    return _unlane_view(out)[:n].tobytes()
