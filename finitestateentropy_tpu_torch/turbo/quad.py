"""TurboRANS-QUAD — order-3 byte coding: 4-byte super-symbols per rANS step.

The r5 pair wire (turbo/pair.py) proved the multi-byte-per-step economics:
per-step cost is the VPU issue bound (table-chunk gathers + renorm
machinery), so amortizing a step over more output bytes is the only lever
left after the interleave axis saturated (PERFORMANCE.md).  QUAD pushes it
to 4 bytes/step: a group is recoded as 4-byte groups ("quads") over a
capped alphabet of at most 256 ids (top-255 + escape), the decode-table
entry packs

    (id << 2*tlog) | (freq << tlog) | (slot - cumul)

in one i32 (id < 256, tlog <= 12 — the same packing as the pair wire),
and a 256-entry i32 LUT maps id -> the raw 4-byte group OFF the serial
path.  Each decode step then writes ONE full output word per lane: spc=1
— one step per (8,128) output tile, no sub-word packing at all.  The
encoder is the spc=1 mode of the shared encode kernel (1 id per u32 src
word): quarter the steps of the byte wire through identical machinery.

Eligibility is narrower than pair's (the 4-gram alphabet must cap at 256
with few escapes — true for skewed corpora like proba80/90, false for
near-uniform ones), which is exactly when the speed matters; ineligible
groups fall back to pair/byte in turbo/api.py's dispatch.

Reference precedent for multi-symbol steps: HUF_decompress4X2 packs 2
symbols per lookup (lib/huf_decompress.c:454-649); QUAD is that move taken
to the TPU's word width.

Wire: byte-TurboRANS framing (magic 0x183EF002, rans.py) with FLAG_QUAD
(bit 7).  n_sym counts BYTES.  Sections, in order:

    header (16 B, rans._HDR)
    ncount    reference FSE_writeNCount over quad ids (maxSV <= 255), 4B-pad
    quad LUT  u32[maxSV+1] quad values (id -> little-endian 4-byte group)
    escapes   ALWAYS present (no flag bit left): u32 n_esc, then n_esc x
              (u32 quad_pos, u32 value)
    init      1024 x u32 lane states
    steptots  FLAG_STEPTOTS [T,8] u8 rows, FLAG_ROWS4-packable;
              T = pad4096(ceil(n/4)) / 1024   (the quad wire is
              steptots-only: its whole point is the fast v2/w decode)
    payload   csize_hw halfwords

Host twin below is the bit-exact model of the spc=1 kernels; the lane
interleave is 1 id per lane slot (out word t*1024+lane = quad t,lane).

Copy of the JAX package's turbo/quad.py; the tests hold it equal to the
original.  The twins quad_compress / quad_decompress are the port's own
oracle for quad groups, so checks on the GPU need no JAX.
"""
from __future__ import annotations

import struct

import numpy as np

from ..refimpl.ncount import fse_read_ncount, fse_write_ncount
from ..refimpl.norm import fse_normalize_count, fse_optimal_table_log
from .format import TURBO_LANES, _pad_n
from .rans import (RANS_L, RANS_MAGIC, _HDR, _pack_rows4, _unpack_rows4,
                   rans_freqs)

FLAG_QUAD = 128      # modifier on the 0x183EF002 wire: payload codes quads
QUAD_MAX_ALPHA = 256

QUAD_TABLELOG = 10   # measured on v5e (tools/probe_r5.py, 1 MiB groups,
                     # p80): decode 58.0 GB/s @ ratio 7.13 (tlog 9),
                     # 47.6 @ 7.77 (tlog 10), 28.5 @ 8.13 (tlog 11) vs
                     # byte wire 18.5 @ 8.30 — tlog 10 is the production
                     # default (2.6x the byte wire for -6.4% ratio, well
                     # inside the speed-for-ratio trade the reference
                     # makes shipping Huff0 at -28%/3x, README.md:32-33);
                     # -M-style override via quad_table_log for 11 (ratio)
                     # or 9 (speed frontier)


def _pad_q(n_quads: int) -> int:
    """Quad count padded to whole supercycles (1024 ids per step, steps
    padded like the byte wire's _pad_n in units of ids)."""
    return _pad_n(max(n_quads, 1) * 4) // 4  # 4096-byte pad -> 1024-id pad


def quad_view(data: bytes | np.ndarray) -> np.ndarray:
    """Bytes -> u32 quad array (tail padded by repeating the last byte)."""
    src = np.frombuffer(data, np.uint8) if isinstance(data, (bytes, bytearray)) \
        else np.ascontiguousarray(data, np.uint8)
    if len(src) % 4:
        src = np.concatenate([src, np.repeat(src[-1:], -len(src) % 4)])
    return src.view("<u4")


def quad_plan(data: bytes | np.ndarray, max_esc_frac: float = 0.01):
    """Eligibility + id mapping: top-255 quads + escape.  Returns None when
    more than max_esc_frac of quads would escape (each escape record costs
    8 B, so the default cap is tighter than the pair wire's)."""
    qv = quad_view(data)
    if len(qv) == 0:
        return None
    uniq, inv, counts = np.unique(qv, return_inverse=True,
                                  return_counts=True)
    if len(uniq) <= QUAD_MAX_ALPHA:
        order = np.arange(len(uniq))
        quads = uniq.astype(np.uint32)       # ascending, canonical
        esc_id = None
        esc_pos = esc_val = None
        remap = np.arange(len(uniq), dtype=np.uint16)
        ids = remap[inv].astype(np.uint8)
        id_counts = counts.astype(np.int64)
    else:
        order = np.argsort(-counts, kind="stable")[: QUAD_MAX_ALPHA - 1]
        n_esc = int(len(qv) - counts[order].sum())
        if n_esc > max_esc_frac * len(qv):
            return None
        keep = np.sort(order)
        quads = uniq[keep].astype(np.uint32)
        esc_id = len(quads)
        remap = np.full(len(uniq), esc_id, np.uint16)
        remap[keep] = np.arange(len(keep), dtype=np.uint16)
        ids16 = remap[inv]
        esc_mask = ids16 == esc_id
        esc_pos = np.nonzero(esc_mask)[0].astype(np.uint32)
        esc_val = qv[esc_mask].astype(np.uint32)
        ids = ids16.astype(np.uint8)
        id_counts = np.concatenate(
            [counts[keep], [len(esc_pos)]]).astype(np.int64)
    return dict(quads=quads, ids=ids, counts=id_counts, esc_id=esc_id,
                esc_pos=esc_pos, esc_val=esc_val, n_quads=len(qv))


def _quad_sections(plan, norm, max_sv: int, tlog: int):
    ncount = fse_write_ncount(norm, max_sv, tlog)
    out = ncount + b"\0" * (-len(ncount) % 4)
    lut = np.zeros(max_sv + 1, "<u4")
    lut[: len(plan["quads"])] = plan["quads"]
    out += lut.tobytes()
    n_esc = 0 if plan["esc_id"] is None else len(plan["esc_pos"])
    out += struct.pack("<I", n_esc)
    if n_esc:
        rec = np.zeros((n_esc, 2), "<u4")
        rec[:, 0] = plan["esc_pos"]
        rec[:, 1] = plan["esc_val"]
        out += rec.tobytes()
    return out, len(ncount)


def prep_quad_group(chunk, table_log: int = 0,
                    max_esc_frac: float = 0.01):
    """Host stats for one quad group; None when ineligible."""
    if table_log == 0:
        table_log = QUAD_TABLELOG
    if len(chunk) < 4:
        return None
    plan = quad_plan(chunk, max_esc_frac)
    if plan is None:
        return None
    ids, counts = plan["ids"], plan["counts"]
    max_sv = len(counts) - 1
    if max_sv == 0:
        return None                      # single quad: byte wire RLEs it
    tlog = min(table_log,
               fse_optimal_table_log(table_log, len(ids), max_sv))
    norm, tlog = fse_normalize_count(tlog, counts, len(ids), max_sv)
    sections, nc_len = _quad_sections(plan, norm, max_sv, tlog)
    return dict(ids=ids, counts=counts, norm=np.asarray(norm, np.int32),
                max_sv=max_sv, tlog=tlog, sections=sections, nc_len=nc_len,
                flags=FLAG_QUAD, quads=plan["quads"],
                mfi=int(counts.argmax()), n=len(chunk))


def quad_compress(data: bytes, table_log: int = 0,
                  max_esc_frac: float = 0.01) -> bytes | None:
    """Host twin encode (steptots wire only — quad exists for decode
    speed).  None when ineligible: callers fall back to pair/byte."""
    n = len(data)
    prep = prep_quad_group(data, table_log, max_esc_frac)
    if prep is None:
        return None
    ids = prep["ids"]
    norm, tlog = prep["norm"], prep["tlog"]

    freq, cumul = rans_freqs(np.asarray(norm))
    fr = np.ones(QUAD_MAX_ALPHA, np.int64)
    cu = np.zeros(QUAD_MAX_ALPHA, np.int64)
    fr[: len(freq)] = freq
    cu[: len(cumul)] = cumul

    n_pad = _pad_q(len(ids))
    src_pad = np.full(n_pad, prep["mfi"], np.int64)
    src_pad[: len(ids)] = ids
    syms = src_pad.reshape(-1, TURBO_LANES)   # 1 id per lane slot
    T = syms.shape[0]

    x = np.full(TURBO_LANES, RANS_L, np.uint64)
    chunks: list[np.ndarray] = []
    tots = np.zeros((T, 8), np.uint8)
    thresh_shift = 32 - tlog
    for t in range(T - 1, -1, -1):
        s = syms[t]
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
    packed = _pack_rows4(tots)
    if packed is not None:
        sect, flags = packed, flags | 4 | 16     # STEPTOTS | ROWS4
    else:
        sect = tots.reshape(-1).tobytes()
        flags |= 4
    out = (_HDR.pack(RANS_MAGIC, n, len(stream), tlog, flags,
                     prep["nc_len"])
           + prep["sections"] + x.astype("<u4").tobytes() + sect
           + stream.astype("<u2").tobytes())
    if len(out) >= n + _HDR.size:
        return None
    return out


def parse_quad_group(blob: bytes):
    """Parse one FLAG_QUAD group -> ((n, csize_hw, tlog, flags, norm,
    max_sv, init, payload, steptots, quads, escapes), used) — the same
    11-slot shape as parse_pair_group (api batching shares the layout);
    quads is the id -> u32 LUT, escapes None or (pos u32[], val u32[])."""
    magic, n, csize_hw, tlog, flags, nc_len = _HDR.unpack_from(blob, 0)
    if magic != RANS_MAGIC or not flags & FLAG_QUAD:
        raise ValueError("not a turbo-quad group")
    if not flags & 4:
        raise ValueError("turbo-quad group missing steptots (corrupt)")
    pos = _HDR.size
    norm, max_sv, rtlog, used = fse_read_ncount(blob[pos : pos + nc_len + 8])
    if rtlog != tlog or used > nc_len + 1:
        raise ValueError("turbo-quad ncount corrupt")
    pos += nc_len + (-nc_len % 4)
    lut_len = 4 * (max_sv + 1)
    quads = np.frombuffer(blob[pos : pos + lut_len], "<u4").copy()
    if len(quads) != max_sv + 1:
        raise ValueError("turbo-quad LUT truncated")
    pos += lut_len
    if len(blob) < pos + 4:
        raise ValueError("turbo-quad escape section truncated")
    (n_esc,) = struct.unpack_from("<I", blob, pos)
    eb = 4 + 8 * n_esc
    n_quads = (n + 3) // 4
    if n_esc > n_quads or len(blob) < pos + eb:
        raise ValueError("turbo-quad escape section corrupt")
    escapes = None
    if n_esc:
        rec = np.frombuffer(blob[pos + 4 : pos + eb], "<u4").reshape(-1, 2)
        if int(rec[:, 0].max(initial=0)) >= n_quads:
            raise ValueError("turbo-quad escape position out of range")
        escapes = (rec[:, 0].copy(), rec[:, 1].copy())
    pos += eb
    init = np.frombuffer(blob[pos : pos + 4 * TURBO_LANES], "<u4").copy()
    pos += 4 * TURBO_LANES
    T = _pad_q(n_quads) // TURBO_LANES
    if flags & 16:                       # FLAG_ROWS4
        steptots, u = _unpack_rows4(blob[pos:], T)
        pos += u
    else:
        steptots = np.frombuffer(blob[pos : pos + T * 8],
                                 np.uint8).reshape(T, 8).copy()
        pos += T * 8
    payload = blob[pos : pos + 2 * csize_hw]
    pos += 2 * csize_hw
    return (n, csize_hw, tlog, flags, np.asarray(norm, np.int32), max_sv,
            init, payload, steptots, quads, escapes), pos


def apply_escapes(quad_u32: np.ndarray, escapes) -> np.ndarray:
    if escapes is not None and len(escapes[0]):
        quad_u32[escapes[0]] = escapes[1]
    return quad_u32


def quad_decompress(blob: bytes) -> bytes:
    """Host twin decode (bit-exact model of the spc=1 decode kernels)."""
    (n, csize_hw, tlog, flags, norm, max_sv, init, payload, steptots,
     quads, escapes), _ = parse_quad_group(blob)

    freq, cumul = rans_freqs(norm)
    m = 1 << tlog
    bounds = np.concatenate([cumul, [m]])
    sid_of = np.searchsorted(bounds, np.arange(m), side="right") - 1
    f_of = freq[sid_of].astype(np.uint64)
    j_of = (np.arange(m) - cumul[sid_of]).astype(np.uint64)
    qv_of = quads[sid_of]                     # slot -> quad value (LUT
    # gather, fused here since the twin has no issue bound)
    hw = np.frombuffer(payload, "<u2").astype(np.uint64)
    m_mask = np.uint64(m - 1)

    n_quads = (n + 3) // 4
    n_pad = _pad_q(n_quads)
    T = n_pad // TURBO_LANES
    x = init.astype(np.uint64)
    out = np.zeros((T, TURBO_LANES), np.uint32)
    cursor = csize_hw
    for t in range(T):
        slot = x & m_mask
        out[t] = qv_of[slot]
        x = f_of[slot] * (x >> np.uint64(tlog)) + j_of[slot]
        flag = x < np.uint64(RANS_L)
        if not np.array_equal(flag.reshape(8, 128).sum(axis=1), steptots[t]):
            raise ValueError("turbo-quad stream corrupt (steptots)")
        rank = np.cumsum(flag)
        p = cursor - rank
        v = (hw[np.clip(p, 0, max(len(hw) - 1, 0))] if len(hw)
             else np.zeros(len(p), np.uint64))
        x = np.where(flag, (x << np.uint64(16)) | v, x)
        cursor -= int(rank[-1])
    if cursor != 0 or not (x == RANS_L).all():
        raise ValueError("turbo-quad stream corrupt")
    qu = out.reshape(-1)[:n_quads].copy()
    return apply_escapes(qu, escapes).tobytes()[:n]
