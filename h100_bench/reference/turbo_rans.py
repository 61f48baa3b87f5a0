"""The plain reference for TurboRANS frames: a decoder written from the wire
format alone, in plain PyTorch, that shares no code with the program.

A frame is a run of groups.  Each group starts with a 16-byte header
(u32 magic 0x183EF002, u32 n bytes, u32 payload halfwords, u8 tableLog,
u8 flags, u16 NCount length).  Flags: 1 raw bytes, 2 one repeated byte;
otherwise rANS over 1024 interleaved lanes, with 4 a section of per-step
row counts (16: nibble-packed), 8 a section of per-step totals, 32 the pair
wire (2-byte symbols through a LUT, 64: escapes), 128 the quad wire
(4-byte symbols through a LUT, escapes always present).  After the NCount
come the wire's LUT and escapes, 1024 u32 initial lane states, the section
and the payload halfwords, which the lanes read downward from the end.

Every coded group of one wire, step count, tableLog and kind of section
decodes in one batch on the given device: the lane states step together,
a lane that drops under 2^16 reads the next halfword (lanes in ascending
order take descending positions).  A group decodes only if every lane
ends at 2^16, every halfword is read exactly once, and each step's
renormalizations match the section the frame ships, since the program's
parallel decoders place their reads from that section.
"""
from __future__ import annotations

import struct

import numpy as np
import torch

from h100_bench.reference.ncount import FrameError, read_ncount

MAGIC = 0x183EF002
LANES = 1024
RANS_L = 1 << 16
F_RAW, F_RLE, F_STEPTOTS, F_TOTALS, F_ROWS4 = 1, 2, 4, 8, 16
F_PAIR, F_PAIRESC, F_QUAD = 32, 64, 128
HDR = struct.Struct("<IIIBBH")
MAX_BATCH_GROUPS = 256    # groups decoded together (bounds device memory)


def _ceil_to(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def steps_of(wire: str, n: int) -> int:
    """Decode steps of an n-byte group: a byte a lane-step padded to 4096
    bytes; a pair a lane-step padded to 2048 pairs; a quad a lane-step
    padded to 1024 quads."""
    if wire == "quad":
        return _ceil_to(max((n + 3) // 4, 1) * 4, 4096) // 4 // LANES
    if wire == "pair":
        return _ceil_to((n + 1) // 2, 2048) // LANES
    return _ceil_to(n, 4096) // LANES


def _rows4(buf: bytes, pos: int, T: int) -> tuple[np.ndarray, int]:
    """A nibble-packed row-count section: u32 escape count, the escapes
    (u16 step, u8 row, u8 count), then two steps a byte row."""
    if len(buf) < pos + 4:
        raise FrameError("rows section truncated")
    (n_exc,) = struct.unpack_from("<I", buf, pos)
    body = pos + 4 + 4 * n_exc
    tp = T + (T & 1)
    if n_exc > 8 * T or len(buf) < body + 4 * tp:
        raise FrameError("rows section corrupt")
    packed = np.frombuffer(buf, np.uint8, 4 * tp, body).reshape(tp // 2, 8)
    rows = np.empty((tp, 8), np.uint8)
    rows[0::2] = packed & 15
    rows[1::2] = packed >> 4
    rows = rows[:T].copy()
    if n_exc:
        e = np.frombuffer(buf, np.uint8, 4 * n_exc, pos + 4).reshape(n_exc, 4)
        step = e[:, 0].astype(np.int64) | (e[:, 1].astype(np.int64) << 8)
        if (step >= T).any() or (e[:, 2] >= 8).any():
            raise FrameError("rows escape out of range")
        rows[step, e[:, 2]] = e[:, 3]
    return rows, body + 4 * tp


def parse_group(buf: bytes, pos: int) -> tuple[dict, int]:
    """One group at buf[pos:] -> (its fields, the position after it)."""
    if len(buf) < pos + HDR.size:
        raise FrameError("group header truncated")
    magic, n, csize, tlog, flags, nc_len = HDR.unpack_from(buf, pos)
    if magic != MAGIC:
        raise FrameError("bad magic")
    p = pos + HDR.size
    if flags & F_RAW:
        if len(buf) < p + n:
            raise FrameError("raw group truncated")
        return {"kind": "raw", "n": n, "bytes": buf[p:p + n]}, p + n
    if flags & F_RLE:
        if len(buf) < p + 4:
            raise FrameError("rle group truncated")
        return {"kind": "rle", "n": n, "byte": buf[p]}, p + 4
    wire = "quad" if flags & F_QUAD else "pair" if flags & F_PAIR else "byte"
    norm, max_sv, rtlog, used = read_ncount(buf[p:p + nc_len + 8])
    if rtlog != tlog or used > nc_len + 1:
        raise FrameError("ncount disagrees with the header")
    p += _ceil_to(nc_len, 4)
    g = {"kind": wire, "n": n, "csize": csize, "tlog": tlog,
         "norm": np.asarray(norm, np.int64), "lut": None, "esc": None}
    if wire == "pair":
        g["lut"] = np.frombuffer(buf, "<u2", max_sv + 1, p).astype(np.int64)
        p += _ceil_to(2 * (max_sv + 1), 4)
        if flags & F_PAIRESC:
            (n_esc,) = struct.unpack_from("<I", buf, p)
            rec = np.frombuffer(buf, np.uint8, 6 * n_esc, p + 4).reshape(-1, 6)
            g["esc"] = (rec[:, :4].copy().view("<u4").reshape(-1).astype(np.int64),
                        rec[:, 4:].copy().view("<u2").reshape(-1).astype(np.int64))
            p += _ceil_to(4 + 6 * n_esc, 4)
    elif wire == "quad":
        g["lut"] = np.frombuffer(buf, "<u4", max_sv + 1, p).astype(np.int64)
        p += 4 * (max_sv + 1)
        (n_esc,) = struct.unpack_from("<I", buf, p)
        rec = np.frombuffer(buf, "<u4", 2 * n_esc, p + 4).reshape(-1, 2)
        if n_esc:
            g["esc"] = (rec[:, 0].astype(np.int64), rec[:, 1].astype(np.int64))
        p += 4 + 8 * n_esc
    if len(buf) < p + 4 * LANES:
        raise FrameError("initial states truncated")
    g["init"] = np.frombuffer(buf, "<u4", LANES, p).astype(np.int64)
    p += 4 * LANES
    T = steps_of(wire, n)
    g["T"] = T
    g["rows"] = g["totals"] = None
    if flags & F_STEPTOTS:
        if flags & F_ROWS4:
            g["rows"], p = _rows4(buf, p, T)
        else:
            if len(buf) < p + 8 * T:
                raise FrameError("rows section truncated")
            g["rows"] = np.frombuffer(buf, np.uint8, 8 * T, p).reshape(T, 8)
            p += 8 * T
    elif flags & F_TOTALS:
        if len(buf) < p + 2 * T:
            raise FrameError("totals section truncated")
        g["totals"] = np.frombuffer(buf, "<u2", T, p).astype(np.int64)
        p += 2 * T
    if len(buf) < p + 2 * csize:
        raise FrameError("payload truncated")
    g["hw"] = np.frombuffer(buf, "<u2", csize, p).astype(np.int64)
    return g, p + 2 * csize


def parse_frame(buf: bytes) -> list[dict]:
    groups, pos = [], 0
    while pos < len(buf):
        g, pos = parse_group(buf, pos)
        groups.append(g)
    return groups


def _slot_tables(g: dict) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """slot -> (symbol value, frequency, slot - cumulative frequency) of a
    group's table of 2^tableLog slots (a count of -1 takes one slot)."""
    freq = np.where(g["norm"] == -1, 1, g["norm"])
    cumul = np.concatenate([[0], np.cumsum(freq)[:-1]])
    m = 1 << g["tlog"]
    if freq.sum() != m or (freq < 0).any():
        raise FrameError("normalized counts do not fill the table")
    sym = np.repeat(np.arange(len(freq)), freq)
    val = sym if g["lut"] is None else g["lut"][sym]
    return val, freq[sym], np.arange(m) - cumul[sym]


def _decode_batch(gs: list[dict], device) -> list[np.ndarray | None]:
    """Lane outputs [T, 1024] of groups of one wire, step count, tableLog
    and kind of section, or None for a group that does not decode."""
    G, T, tlog = len(gs), gs[0]["T"], gs[0]["tlog"]
    tabs = [_slot_tables(g) for g in gs]

    def dev(a, dtype=torch.int64):
        return torch.as_tensor(np.stack(a), dtype=dtype, device=device)

    val, freq, off = (dev([t[i] for t in tabs]) for i in range(3))
    width = max(max(len(g["hw"]) for g in gs), 1)
    hw = dev([np.pad(g["hw"], (0, width - len(g["hw"]))) for g in gs])
    x = dev([g["init"] for g in gs])
    cursor = torch.tensor([g["csize"] for g in gs], dtype=torch.int64,
                          device=device)
    rows = totals = None                # one kind of section a batch
    if gs[0]["rows"] is not None:
        rows = dev([g["rows"] for g in gs])                 # [G, T, 8]
    elif gs[0]["totals"] is not None:
        totals = dev([g["totals"] for g in gs])             # [G, T]
    out_dtype = torch.uint8 if gs[0]["kind"] == "byte" else torch.int64
    out = torch.empty((G, T, LANES), dtype=out_dtype, device=device)
    bad = torch.zeros(G, dtype=torch.bool, device=device)
    mask = (1 << tlog) - 1
    for t in range(T):
        slot = x & mask
        out[:, t] = torch.gather(val, 1, slot).to(out_dtype)
        x = torch.gather(freq, 1, slot) * (x >> tlog) + torch.gather(off, 1, slot)
        flag = x < RANS_L
        if rows is not None:
            bad |= (flag.view(G, 8, 128).sum(-1) != rows[:, t]).any(-1)
        elif totals is not None:
            bad |= flag.sum(-1) != totals[:, t]
        rank = torch.cumsum(flag, 1)
        pos = cursor[:, None] - rank
        bad |= (flag & (pos < 0)).any(-1)
        fresh = torch.gather(hw, 1, pos.clamp(0, width - 1))
        x = torch.where(flag, (x << 16) | fresh, x)
        cursor = cursor - rank[:, -1]
    ok = ~bad & (cursor == 0) & (x == RANS_L).all(-1)
    ok, out = ok.cpu().numpy(), out.cpu().numpy()
    return [out[j] if ok[j] else None for j in range(G)]


def _group_bytes(g: dict, lanes: np.ndarray) -> bytes:
    """A group's bytes from its lane outputs [T, 1024] (escapes patched)."""
    T, n = g["T"], g["n"]
    if g["kind"] == "byte":      # byte 4(1024 t4 + k) + p at step 4 t4 + p
        return lanes.reshape(T // 4, 4, LANES).transpose(0, 2, 1).tobytes()[:n]
    if g["kind"] == "pair":      # pair 2(1024 t2 + k) + p at step 2 t2 + p
        vals = lanes.reshape(T // 2, 2, LANES).transpose(0, 2, 1).reshape(-1)
        count, dtype = (n + 1) // 2, "<u2"
    else:                        # quad 1024 t + k at step t
        vals, count, dtype = lanes.reshape(-1), (n + 3) // 4, "<u4"
    vals = vals[:count].copy()
    if g["esc"] is not None:
        pos, v = g["esc"]
        if len(pos) and int(pos.max()) >= count:
            raise FrameError("escape position out of range")
        vals[pos] = v
    return vals.astype(dtype).tobytes()[:n]


def decode_frames(frames: list[bytes], device="cpu") -> list[bytes | None]:
    """Each frame's decoded bytes, or None where the frame is not a valid
    TurboRANS stream."""
    parsed: list[list[dict] | None] = []
    for f in frames:
        try:
            parsed.append(parse_frame(f))
        except (FrameError, struct.error, ValueError):
            parsed.append(None)
    batches: dict[tuple, list[tuple[int, int]]] = {}
    for fi, groups in enumerate(parsed):
        for gi, g in enumerate(groups or ()):
            if g["kind"] in ("byte", "pair", "quad"):
                section = ("rows" if g["rows"] is not None else
                           "totals" if g["totals"] is not None else None)
                batches.setdefault((g["kind"], g["T"], g["tlog"], section),
                                   []).append((fi, gi))
    pieces: dict[tuple[int, int], bytes | None] = {}
    for members in batches.values():
        for lo in range(0, len(members), MAX_BATCH_GROUPS):
            part = members[lo:lo + MAX_BATCH_GROUPS]
            gs = [parsed[fi][gi] for fi, gi in part]
            try:
                lanes = _decode_batch(gs, device)
            except FrameError:
                lanes = [None] * len(gs)
            for key, g, ln in zip(part, gs, lanes):
                try:
                    pieces[key] = None if ln is None else _group_bytes(g, ln)
                except FrameError:
                    pieces[key] = None
    out: list[bytes | None] = []
    for fi, groups in enumerate(parsed):
        if groups is None:
            out.append(None)
            continue
        chunks = []
        for gi, g in enumerate(groups):
            if g["kind"] == "raw":
                chunks.append(g["bytes"])
            elif g["kind"] == "rle":
                chunks.append(bytes([g["byte"]]) * g["n"])
            else:
                chunks.append(pieces[(fi, gi)])
        out.append(None if any(c is None for c in chunks) else b"".join(chunks))
    return out
