"""TurboRANS-PAIR — order-1 byte coding: 2-byte super-symbols per rANS step.

The decode kernels' per-step cost is dominated by per-128-lane table-chunk
gathers (PERFORMANCE.md: the VPU issue bound), so amortizing each step over
TWO bytes nearly doubles throughput *if* the pair alphabet keeps the table
gather small.  This wire recodes a byte group as u16 byte-pairs over a
capped alphabet of at most 256 distinct pairs (top-255 + escape when the
tail is small): the decode table entry then packs

    (pair_id << 2*tlog) | (freq << tlog) | (slot - cumul)

into one i32 (fits for tableLog <= 12 since pair_id < 256), and a 2-chunk
256-entry LUT maps pair_id -> the raw 16-bit pair value off the serial
path.  Per step: 8 main-table chunks (tlog 10) + 2 LUT chunks vs the byte
wire's 8 — ~1.2x the step cost for 2x the bytes.  The encoder is the
EXISTING u16-mode kernel with 2-chunk symbol tables (ids < 256): half the
steps of the byte wire through identical machinery.

Multi-symbol-per-step precedent in the reference: HUF_decompress4X2 packs
2 symbols per table lookup (lib/huf_decompress.c:454-649).  Escapes: pairs
outside the top-255 map to the ESC id and ship as (pos,u16) records,
patched after decode — the analogue of HUF X2's partial-symbol escape row.

Wire: the byte-TurboRANS framing (magic 0x183EF002, rans.py) with
FLAG_PAIR set.  n_sym counts BYTES.  Sections, in order:

    header (16 B, rans._HDR)
    ncount    reference FSE_writeNCount over pair ids (maxSV <= 255), 4B-pad
    pair LUT  u16[maxSV+1] pair values (id -> little-endian byte pair), 4B-pad
    escapes   (only if FLAG_PAIRESC) u32 n_esc, then n_esc x (u32 pair_pos,
              u16 value), the array 4B-padded
    init      1024 x u32 lane states
    steptots  (speed mode) FLAG_STEPTOTS [T,8] u8 rows, FLAG_ROWS4-packable;
              T = pad16(ceil(n/2)) / 1024
    payload   csize_hw halfwords

Host twin below is the bit-exact model of the pair-mode kernels (tests
compare byte-for-byte); the lane interleave is rans16.py's (2 symbols per
lane slot, 2048-symbol supercycles).

Copy of the JAX package's turbo/pair.py; the tests hold it equal to the
original.  The twins pair_compress / pair_decompress are the port's own
oracle for pair groups, so checks on the GPU need no JAX.
"""
from __future__ import annotations

import struct

import numpy as np

from ..refimpl.ncount import fse_read_ncount, fse_write_ncount
from ..refimpl.norm import fse_normalize_count, fse_optimal_table_log
from .format import TURBO_LANES
from .rans import (RANS_L, RANS_MAGIC, RANS_SPEED_TABLELOG, _HDR,
                   _pack_rows4, _unpack_rows4, rans_freqs)
from .rans16 import _lane_view16, _pad_n16, _unlane_view16

FLAG_PAIR = 32       # modifier on the 0x183EF002 wire: payload codes pairs
FLAG_PAIRESC = 64    # escape section present (pairs outside the top-255)
PAIR_MAX_ALPHA = 256

_ESC = struct.Struct("<IH")


def pair_view(data: bytes | np.ndarray) -> np.ndarray:
    """Bytes -> u16 pair array (odd tail padded by repeating the last
    byte; the decoder trims to n bytes, so the pad value is free)."""
    src = np.frombuffer(data, np.uint8) if isinstance(data, (bytes, bytearray)) \
        else np.ascontiguousarray(data, np.uint8)
    if len(src) % 2:
        src = np.concatenate([src, src[-1:]])
    return src.view("<u2")


def pair_plan(data: bytes | np.ndarray, max_esc_frac: float = 0.02):
    """Eligibility + id mapping for one group.

    Returns None when the pair alphabet can't be capped at 256 ids without
    more than max_esc_frac of pairs escaping; else a dict with the sorted
    pair LUT, the ESC id (or None), per-pair ids, and escape records."""
    pv = pair_view(data)
    if len(pv) == 0:
        return None
    counts = np.bincount(pv, minlength=65536)
    nz = np.nonzero(counts)[0]
    if len(nz) <= PAIR_MAX_ALPHA:
        pairs = nz.astype(np.uint16)          # sorted ascending, canonical
        esc_id = None
        esc_pos = esc_val = None
        lut_inv = np.zeros(65536, np.uint16)
        lut_inv[pairs] = np.arange(len(pairs), dtype=np.uint16)
        ids = lut_inv[pv]
        id_counts = counts[pairs].astype(np.int64)
    else:
        # keep the top-255 pairs; the rest escape.  Ties broken by pair
        # value (argsort is stable on the negated counts)
        order = np.argsort(-counts, kind="stable")[: PAIR_MAX_ALPHA - 1]
        n_esc = int(len(pv) - counts[order].sum())
        if n_esc > max_esc_frac * len(pv):
            return None
        pairs = np.sort(order).astype(np.uint16)
        esc_id = len(pairs)                   # ESC is the last id
        lut_inv = np.full(65536, esc_id, np.uint16)
        lut_inv[pairs] = np.arange(len(pairs), dtype=np.uint16)
        ids = lut_inv[pv]
        esc_mask = ids == esc_id
        esc_pos = np.nonzero(esc_mask)[0].astype(np.uint32)
        esc_val = pv[esc_mask]
        id_counts = np.concatenate(
            [counts[pairs], [len(esc_pos)]]).astype(np.int64)
    return dict(pairs=pairs, ids=ids, counts=id_counts, esc_id=esc_id,
                esc_pos=esc_pos, esc_val=esc_val, n_pairs=len(pv))


def _pair_sections(plan, norm, max_sv: int, tlog: int) -> bytes:
    """ncount + LUT (+ escapes) section bytes (everything between the
    header and the init states)."""
    ncount = fse_write_ncount(norm, max_sv, tlog)
    out = ncount + b"\0" * (-len(ncount) % 4)
    lut = np.zeros(max_sv + 1, "<u2")
    lut[: len(plan["pairs"])] = plan["pairs"]
    lb = lut.tobytes()
    out += lb + b"\0" * (-len(lb) % 4)
    if plan["esc_id"] is not None:
        eb = struct.pack("<I", len(plan["esc_pos"]))
        rec = np.zeros((len(plan["esc_pos"]), 6), np.uint8)
        rec[:, :4] = plan["esc_pos"].astype("<u4").view(np.uint8).reshape(-1, 4)
        rec[:, 4:] = plan["esc_val"].astype("<u2").view(np.uint8).reshape(-1, 2)
        eb += rec.tobytes()
        out += eb + b"\0" * (-len(eb) % 4)
    return out, len(ncount)


PAIR_TABLELOG = 9   # speed default: 4 main chunks + 2 LUT chunks per step
                    # measured on v5e (tools/probe_r5.py, windowed 8-way):
                    # 37.5-38.3 GB/s @ ratio 8.07-8.22 vs 25.3-26.9 @
                    # 8.23-8.39 at tlog 10 — the same speed-for-ratio
                    # trade the reference makes shipping Huff0 (6.38 @ 3x
                    # FSE speed, README.md:32)


def prep_pair_group(chunk, table_log: int = 0,
                    max_esc_frac: float = 0.02):
    """Host stats for one pair group (the device encode path's analogue of
    api._prep_group).  Returns None when ineligible, else a dict with the
    id array, normalized counts, and pre-serialized header sections."""
    if table_log == 0:
        table_log = PAIR_TABLELOG
    if len(chunk) < 2:
        return None
    plan = pair_plan(chunk, max_esc_frac)
    if plan is None:
        return None
    ids, counts = plan["ids"], plan["counts"]
    max_sv = len(counts) - 1
    if max_sv == 0:
        return None                      # single pair: byte wire RLEs it
    tlog = min(table_log,
               fse_optimal_table_log(table_log, len(ids), max_sv))
    norm, tlog = fse_normalize_count(tlog, counts, len(ids), max_sv)
    sections, nc_len = _pair_sections(plan, norm, max_sv, tlog)
    flags = FLAG_PAIR | (FLAG_PAIRESC if plan["esc_id"] is not None else 0)
    return dict(ids=ids, counts=counts, norm=np.asarray(norm, np.int32),
                max_sv=max_sv, tlog=tlog, sections=sections, nc_len=nc_len,
                flags=flags, pairs=plan["pairs"],
                mfi=int(counts.argmax()), n=len(chunk))


def predicted_bits(norm, counts, tlog: int) -> float:
    """Exact rANS payload bits for coding `counts` with table `norm` (the
    init-state free-symbol credit is the same for every wire, so it
    cancels in wire-vs-wire comparisons)."""
    f = np.where(np.asarray(norm) == -1, 1, np.asarray(norm)).astype(np.float64)
    c = np.asarray(counts, np.float64)
    nz = c > 0
    return float((c[nz] * (tlog - np.log2(f[nz]))).sum())


def pair_compress(data: bytes, table_log: int = 0, steptots: bool = True,
                  max_esc_frac: float = 0.02) -> bytes | None:
    """Host twin encode.  Returns None when the group is ineligible (pair
    alphabet too wide) — callers fall back to the byte wire.  RLE/raw
    short-circuits are the byte wire's job (rans.py / api.py), not ours."""
    n = len(data)
    prep = prep_pair_group(data, table_log, max_esc_frac)
    if prep is None:
        return None
    ids = prep["ids"]
    norm, tlog = prep["norm"], prep["tlog"]
    sections, nc_len = prep["sections"], prep["nc_len"]

    freq, cumul = rans_freqs(np.asarray(norm))
    fr = np.ones(PAIR_MAX_ALPHA, np.int64)
    cu = np.zeros(PAIR_MAX_ALPHA, np.int64)
    fr[: len(freq)] = freq
    cu[: len(cumul)] = cumul

    mfi = prep["mfi"]
    n_pad = _pad_n16(len(ids))
    src_pad = np.full(n_pad, mfi, np.uint16)
    src_pad[: len(ids)] = ids
    syms = _lane_view16(src_pad)
    T = syms.shape[0]

    x = np.full(TURBO_LANES, RANS_L, np.uint64)
    chunks: list[np.ndarray] = []
    tots = np.zeros((T, 8), np.uint8)
    thresh_shift = 32 - tlog
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
        x = (q << np.uint64(tlog)) + c + (x - q * f)
    stream = np.concatenate(chunks) if chunks else np.zeros(0, np.uint16)

    flags = prep["flags"]
    if steptots:
        packed = _pack_rows4(tots)
        if packed is not None:
            sect = packed
            flags |= 4 | 16              # FLAG_STEPTOTS | FLAG_ROWS4
        else:
            sect = tots.reshape(-1).tobytes()
            flags |= 4
    else:
        sect = b""
    out = (_HDR.pack(RANS_MAGIC, n, len(stream), tlog, flags, nc_len)
           + sections + x.astype("<u4").tobytes() + sect
           + stream.astype("<u2").tobytes())
    if len(out) >= n + _HDR.size:
        return None                      # byte wire raw-falls-back cheaper
    return out


def parse_pair_group(blob: bytes):
    """Parse one FLAG_PAIR group.  Returns ((n, csize_hw, tlog, flags, norm,
    max_sv, init, payload, steptots, pairs, escapes), used) — the first 9
    slots match rans.parse_rans_group so batching code can share shape
    logic; pairs is the id->u16 LUT, escapes is None or (pos u32[], val
    u16[])."""
    magic, n, csize_hw, tlog, flags, nc_len = _HDR.unpack_from(blob, 0)
    if magic != RANS_MAGIC or not flags & FLAG_PAIR:
        raise ValueError("not a turbo-pair group")
    pos = _HDR.size
    norm, max_sv, rtlog, used = fse_read_ncount(bytes(blob[pos : pos + nc_len + 8]))
    if rtlog != tlog or used > nc_len + 1:
        raise ValueError("turbo-pair ncount corrupt")
    pos += nc_len + (-nc_len % 4)
    lut_len = 2 * (max_sv + 1)
    pairs = np.frombuffer(blob[pos : pos + lut_len], "<u2").copy()
    if len(pairs) != max_sv + 1:
        raise ValueError("turbo-pair LUT truncated")
    pos += lut_len + (-lut_len % 4)
    escapes = None
    if flags & FLAG_PAIRESC:
        if len(blob) < pos + 4:
            raise ValueError("turbo-pair escape section truncated")
        (n_esc,) = struct.unpack_from("<I", blob, pos)
        eb = 4 + 6 * n_esc
        if n_esc > (n + 1) // 2 or len(blob) < pos + eb:
            raise ValueError("turbo-pair escape section corrupt")
        rec = np.frombuffer(blob[pos + 4 : pos + eb], np.uint8).reshape(-1, 6)
        epos = rec[:, :4].copy().view("<u4").reshape(-1)
        eval_ = rec[:, 4:].copy().view("<u2").reshape(-1)
        if len(epos) and int(epos.max()) >= (n + 1) // 2:
            raise ValueError("turbo-pair escape position out of range")
        escapes = (epos, eval_)
        pos += eb + (-eb % 4)
    init = np.frombuffer(blob[pos : pos + 4 * TURBO_LANES], "<u4").copy()
    pos += 4 * TURBO_LANES
    steptots = None
    T = _pad_n16((n + 1) // 2) // TURBO_LANES
    if flags & 4:                        # FLAG_STEPTOTS
        if flags & 16:                   # FLAG_ROWS4
            steptots, u = _unpack_rows4(memoryview(blob)[pos:], T)
            pos += u
        else:
            steptots = np.frombuffer(blob[pos : pos + T * 8],
                                     np.uint8).reshape(T, 8).copy()
            pos += T * 8
    payload = blob[pos : pos + 2 * csize_hw]
    pos += 2 * csize_hw
    return (n, csize_hw, tlog, flags, np.asarray(norm, np.int32), max_sv,
            init, payload, steptots, pairs, escapes), pos


def apply_escapes(pair_u16: np.ndarray, escapes) -> np.ndarray:
    """Patch escaped positions (pair-index order) with their raw values."""
    if escapes is not None and len(escapes[0]):
        pair_u16[escapes[0]] = escapes[1]
    return pair_u16


def pair_decompress(blob: bytes) -> bytes:
    """Host twin decode (bit-exact model of the pair-mode decode kernels)."""
    (n, csize_hw, tlog, flags, norm, max_sv, init, payload, steptots,
     pairs, escapes), _ = parse_pair_group(blob)

    freq, cumul = rans_freqs(norm)
    m = 1 << tlog
    bounds = np.concatenate([cumul, [m]])
    sid_of = np.searchsorted(bounds, np.arange(m), side="right") - 1
    f_of = freq[sid_of].astype(np.uint64)
    j_of = (np.arange(m) - cumul[sid_of]).astype(np.uint64)
    pv_of = pairs[sid_of].astype(np.uint16)   # slot -> pair value (the
    # kernel's LUT gather, fused here since the twin has no issue bound)
    hw = np.frombuffer(payload, "<u2").astype(np.uint64)
    m_mask = np.uint64(m - 1)

    n_pairs = (n + 1) // 2
    n_pad = _pad_n16(n_pairs)
    T = n_pad // TURBO_LANES
    x = init.astype(np.uint64)
    out = np.zeros((T, TURBO_LANES), np.uint16)
    cursor = csize_hw
    for t in range(T):
        slot = x & m_mask
        out[t] = pv_of[slot]
        x = f_of[slot] * (x >> np.uint64(tlog)) + j_of[slot]
        flag = x < np.uint64(RANS_L)
        if steptots is not None and not np.array_equal(
                flag.reshape(8, 128).sum(axis=1), steptots[t]):
            raise ValueError("turbo-pair stream corrupt (steptots)")
        rank = np.cumsum(flag)
        p = cursor - rank
        v = (hw[np.clip(p, 0, max(len(hw) - 1, 0))] if len(hw)
             else np.zeros(len(p), np.uint64))
        x = np.where(flag, (x << np.uint64(16)) | v, x)
        cursor -= int(rank[-1])
    if cursor != 0 or not (x == RANS_L).all():
        raise ValueError("turbo-pair stream corrupt")
    pu = _unlane_view16(out)[:n_pairs].copy()
    return apply_escapes(pu, escapes).tobytes()[:n]
