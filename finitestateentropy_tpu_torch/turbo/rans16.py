"""TurboRANS-U16 — lane-interleaved rANS for 16-bit symbol alphabets.

The reference's fseU16 (lib/fseU16.c, alphabets > 256 for distance/length
streams) maps to the same 1024-lane rANS machine with a wider symbol type:

* maxSymbolValue <= 4095 (the reference's absolute max, fseU16.c:54).
  Symbols <= 1023 run tableLog 11 with single-word decode entries
  ((cumul << 21) | (freq << 10) | sym); 1024..4095 need tableLog 12-13
  (FSE_minTableLog, same reason the reference's FSEU16 runs 12-13) and
  split decode tables — (freq << 13) | (slot-cumul) plus a symbol plane —
  because 12+13+13 bits don't fit one 32-bit entry.
* each output i32 word carries 2 u16 symbols, so a supercycle is 2 steps:
  symbol i = 2*(t2*1024 + k) + p handled by lane k at step 2*t2 + p.

Wire layout matches rans.py with magic 0x183EF003 and n_sym counted in
u16 symbols.

Copy of the JAX package's turbo/rans16.py; the tests hold it equal to the
original.  The numpy twin rans16_compress / rans16_decompress is the
port's own oracle for U16 frames, so checks on the GPU need no JAX.  The
pair wire reuses its lane layout (_pad_n16, _lane_view16).
"""
from __future__ import annotations

import struct

import numpy as np

from ..refimpl.ncount import fse_read_ncount, fse_write_ncount
from ..refimpl.norm import fse_normalize_count, fse_optimal_table_log
from .format import TURBO_LANES
from .rans import RANS_L, RANS_TABLELOG, rans_freqs

RANS16_MAGIC = 0x183EF003
RANS16_MAX_SYMBOL = 4095       # reference absolute max (fseU16.c:54); the
                               # device kernels use split-table packing for
                               # symbols > 1023 (r2) — no wire change, the
                               # table builds from the NCount header
RANS16_KERNEL_MAX_PACKED = 1023  # single-table (cumul<<21|freq<<10|sym) cap
RANS16_STEP_SYMS = 2048        # symbols per supercycle (2 per lane slot)
FLAG_RAW = 1
FLAG_RLE = 2
FLAG_STEPTOTS = 4   # v2: per-step per-row renorm counts section present

_HDR = struct.Struct("<IIIBBH")


def _pad_n16(n: int) -> int:
    return (n + RANS16_STEP_SYMS - 1) // RANS16_STEP_SYMS * RANS16_STEP_SYMS


def _lane_view16(src_pad: np.ndarray):
    """[N] u16 symbols -> [T, 1024] in (decode step, lane) order."""
    t2 = src_pad.shape[0] // RANS16_STEP_SYMS
    m = src_pad.reshape(t2, TURBO_LANES, 2)
    return m.transpose(0, 2, 1).reshape(t2 * 2, TURBO_LANES)


def _unlane_view16(sym_mat: np.ndarray) -> np.ndarray:
    t = sym_mat.shape[0]
    m = sym_mat.reshape(t // 2, 2, TURBO_LANES).transpose(0, 2, 1)
    return m.reshape(t * TURBO_LANES)


def rans16_decode_table(norm: np.ndarray, table_log: int) -> np.ndarray:
    """slot -> packed i32: (cumul << 21) | (freq << 10) | sym."""
    freq, cumul = rans_freqs(norm)
    m = 1 << table_log
    bounds = np.concatenate([cumul, [m]])
    sym = np.searchsorted(bounds, np.arange(m), side="right") - 1
    e = (cumul[sym] << 21) | (freq[sym] << 10) | sym
    return e.astype(np.int64).astype(np.uint32).view(np.int32)


def rans16_compress(symbols: np.ndarray, steptots: bool = True) -> bytes:
    symbols = np.ascontiguousarray(symbols, dtype=np.uint16)
    n = len(symbols)
    if n == 0:
        return _HDR.pack(RANS16_MAGIC, 0, 0, 0, FLAG_RAW, 0)
    max_sv = int(symbols.max())
    if max_sv > RANS16_MAX_SYMBOL:
        raise ValueError(f"turbo-u16 supports symbols <= {RANS16_MAX_SYMBOL}")
    count = np.bincount(symbols, minlength=max_sv + 1).astype(np.int64)
    if int(count.max()) == n:
        return (_HDR.pack(RANS16_MAGIC, n, 0, 0, FLAG_RLE, 0)
                + int(symbols[0]).to_bytes(2, "little") + b"\0" * 2)

    # alphabets above 1023 need larger tables (FSE_minTableLog: tableLog >=
    # highbit(maxSV)+2 — the reference's FSEU16 runs tableLog 12-13 for the
    # same reason, fseU16.c:43-48); small inputs shrink the table via
    # FSE_optimalTableLog so they don't pay full-size NCount headers
    tlog_req = (RANS_TABLELOG if max_sv <= 1023
                else 12 if max_sv <= 2047 else 13)
    tlog_opt = min(tlog_req,
                   fse_optimal_table_log(tlog_req, n, max_sv, max_allowed=13))
    norm, table_log = fse_normalize_count(
        tlog_opt, count[: max_sv + 1], n, max_sv, max_table_log=13)
    ncount = fse_write_ncount(norm, max_sv, table_log)
    freq, cumul = rans_freqs(np.asarray(norm))
    nsym = max_sv + 1
    fr = np.ones(4096, np.int64)   # unused symbols: freq 1 avoids div-by-0
    cu = np.zeros(4096, np.int64)
    fr[:nsym] = freq
    cu[:nsym] = cumul

    mfs = int(count.argmax())
    n_pad = _pad_n16(n)
    src_pad = np.full(n_pad, mfs, dtype=np.uint16)
    src_pad[:n] = symbols
    syms = _lane_view16(src_pad)
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
            chunks.append((x[flag] & np.uint64(0xFFFF)).astype(np.uint16)[::-1])
            x = np.where(flag, x >> np.uint64(16), x)
        q = x // f
        x = (q << np.uint64(table_log)) + c + (x - q * f)
    stream = np.concatenate(chunks) if chunks else np.zeros(0, np.uint16)
    csize_hw = len(stream)

    ncount_pad = ncount + b"\0" * (-len(ncount) % 4)
    if steptots:
        # T is even (n_pad % 2048 == 0), so T*8 is 4B-aligned
        sect = tots.reshape(-1).tobytes()
        flags_out = FLAG_STEPTOTS
    else:
        sect, flags_out = b"", 0
    out = (
        _HDR.pack(RANS16_MAGIC, n, csize_hw, table_log, flags_out, len(ncount))
        + ncount_pad + x.astype("<u4").tobytes() + sect
        + stream.astype("<u2").tobytes()
    )
    if len(out) >= 2 * n + _HDR.size:
        return _HDR.pack(RANS16_MAGIC, n, 0, 0, FLAG_RAW, 0) + symbols.tobytes()
    return out


def parse_rans16_group(blob: bytes):
    magic, n, csize_hw, table_log, flags, nc_len = _HDR.unpack_from(blob, 0)
    if magic != RANS16_MAGIC:
        raise ValueError("bad turbo-u16 magic")
    pos = _HDR.size
    if flags & FLAG_RAW:
        return (n, 0, 0, flags, None, 0, None, blob[pos : pos + 2 * n],
                None), pos + 2 * n
    if flags & FLAG_RLE:
        return (n, 0, 0, flags, None, 0, None, blob[pos : pos + 2], None), pos + 4
    norm, max_sv, tlog, used = fse_read_ncount(blob[pos : pos + nc_len + 8],
                                               RANS16_MAX_SYMBOL)
    assert tlog == table_log and used <= nc_len + 1
    pos += nc_len + (-nc_len % 4)
    init = np.frombuffer(blob[pos : pos + 4 * TURBO_LANES], dtype="<u4").copy()
    pos += 4 * TURBO_LANES
    steptots = None
    if flags & FLAG_STEPTOTS:
        T = _pad_n16(n) // TURBO_LANES
        steptots = np.frombuffer(blob[pos : pos + T * 8], np.uint8).reshape(T, 8).copy()
        pos += T * 8
    payload = blob[pos : pos + 2 * csize_hw]
    pos += 2 * csize_hw
    return (n, csize_hw, table_log, flags, np.asarray(norm, np.int32), max_sv,
            init, payload, steptots), pos


def rans16_decompress(blob: bytes) -> np.ndarray:
    (n, csize_hw, table_log, flags, norm, max_sv, init, payload,
     steptots), _ = parse_rans16_group(blob)
    if flags & FLAG_RAW:
        return np.frombuffer(payload, "<u2").copy()
    if flags & FLAG_RLE:
        return np.full(n, np.frombuffer(payload, "<u2")[0], np.uint16)

    # twin-internal tables are plain arrays (any alphabet up to 4095); the
    # kernels' bit-packed layouts are kernel-internal, not wire
    freq, cumul = rans_freqs(norm)
    m = 1 << table_log
    bounds = np.concatenate([cumul, [m]])
    sym_of = (np.searchsorted(bounds, np.arange(m), side="right") - 1)
    f_of = freq[sym_of].astype(np.uint64)
    c_of = cumul[sym_of].astype(np.uint64)
    sym_of = sym_of.astype(np.uint64)
    hw = np.frombuffer(payload, dtype="<u2").astype(np.uint64)
    m_mask = np.uint64((1 << table_log) - 1)

    n_pad = _pad_n16(n)
    T = n_pad // TURBO_LANES
    x = init.astype(np.uint64)
    out = np.zeros((T, TURBO_LANES), dtype=np.uint16)
    cursor = csize_hw
    for t in range(T):
        slot = x & m_mask
        out[t] = sym_of[slot].astype(np.uint16)
        f = f_of[slot]
        c = c_of[slot]
        x = f * (x >> np.uint64(table_log)) + slot - c
        flag = x < np.uint64(RANS_L)
        if steptots is not None and not np.array_equal(
                flag.reshape(8, 128).sum(axis=1), steptots[t]):
            raise ValueError("turbo-u16 stream corrupt (steptots)")
        rank = np.cumsum(flag)
        pos = cursor - rank
        v = (hw[np.clip(pos, 0, max(len(hw) - 1, 0))] if len(hw)
             else np.zeros(len(pos), np.uint64))
        x = np.where(flag, (x << np.uint64(16)) | v, x)
        cursor -= int(rank[-1])
    if cursor != 0 or not (x == RANS_L).all():
        raise ValueError("turbo-u16 stream corrupt")
    return _unlane_view16(out)[:n].copy()
