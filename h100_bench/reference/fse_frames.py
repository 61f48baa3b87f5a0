"""The plain reference for `.fse` frames: a reader written from the format
alone (the reference's programs/fileio.c, lib/fse_decompress.c,
lib/bitstream.h and the XXH32 specification), in plain PyTorch and Python,
that shares no code with the program it judges.

A frame is a u32 magic 0x183E2309, a blockSizeID byte (block size 1 <<
(10 + id), id <= 6) and a run of blocks, each led by a descriptor byte:
its top two bits the type (0 compressed, 1 raw, 2 RLE, 3 the trailer), bit
5 set for a full block, else two big-endian bytes of the block's size
follow; a compressed block then has two big-endian bytes of its payload's
size.  A raw block carries its bytes, an RLE block its one byte.  The
trailer's descriptor byte holds the top 6 bits of a 22-bit checksum, the
next two bytes the rest: XXH32(decoded data, seed 0) >> 5.

A compressed block is an NCount header (reference/ncount.py) and an FSE
bitstream read backward from its last byte, whose highest set bit marks the
end.  The decoder's two states start with tableLog bits each; each symbol
is the symbol of its state's cell, and the state then moves to the cell's
newState plus nbBits fresh bits; the states alternate, first, second,
first, ...  A block of n symbols decodes only if the read after symbol n-2
is the first to run past the stream's start (FSE_decompress_usingDTable_
generic then emits one more symbol, from the other state, and stops).

Every compressed block of the frames decodes in one batch on the given
device: the states of all blocks step together, one symbol a step.
"""
from __future__ import annotations

import numpy as np
import torch

from h100_bench.reference.ncount import FrameError, read_ncount

MAGIC = 0x183E2309
BT_COMPRESSED, BT_RAW, BT_RLE, BT_CRC = 0, 1, 2, 3
MAX_BLOCK_SIZE_ID = 6
MAX_TABLELOG = 12             # FSE_MAX_TABLELOG: FSE_decompress refuses more
TABLE_CELLS = 1 << MAX_TABLELOG
MAX_BATCH_BLOCKS = 2048       # blocks decoded together (bounds device memory)

P1, P2, P3, P4, P5 = 2654435761, 2246822519, 3266489917, 668265263, 374761393
M32 = 0xFFFFFFFF


def xxh32(data: bytes, seed: int = 0) -> int:
    """XXH32 of data (the specification's one-shot form)."""
    n = len(data)
    stripes = n // 16
    if stripes:
        words = np.frombuffer(data, "<u4", 4 * stripes)
        acc = []
        for lane, start in enumerate((seed + P1 + P2, seed + P2, seed, seed - P1)):
            v = start & M32
            for w in words[lane::4].tolist():
                v = (v + w * P2) & M32
                v = (v << 13 | v >> 19) * P1 & M32    # bits above 32 drop out
            acc.append(v)
        h = sum((v << r | v >> (32 - r)) & M32
                for v, r in zip(acc, (1, 7, 12, 18))) & M32
    else:
        h = (seed + P5) & M32
    h = (h + n) & M32
    pos = 16 * stripes
    while pos + 4 <= n:
        h = (h + int.from_bytes(data[pos:pos + 4], "little") * P3) & M32
        h = ((h << 17 | h >> 15) & M32) * P4 & M32
        pos += 4
    for b in data[pos:]:
        h = (h + b * P5) & M32
        h = ((h << 11 | h >> 21) & M32) * P1 & M32
    h ^= h >> 15
    h = h * P2 & M32
    h ^= h >> 13
    h = h * P3 & M32
    return h ^ (h >> 16)


def parse_frame(buf: bytes) -> tuple[list[tuple], int]:
    """([("fse", payload, n) | ("raw", bytes, n) | ("rle", byte, n)], the
    trailer's 22-bit checksum) of a whole frame."""
    if len(buf) < 8:
        raise FrameError("frame too short")
    if int.from_bytes(buf[:4], "little") != MAGIC:
        raise FrameError("bad magic")
    if buf[4] > MAX_BLOCK_SIZE_ID:
        raise FrameError("bad blockSizeID")
    block_size = 1 << (10 + buf[4])
    pos, blocks = 5, []

    def take(k: int) -> bytes:
        nonlocal pos
        if pos + k > len(buf):
            raise FrameError("block truncated")
        pos += k
        return buf[pos - k:pos]

    while True:
        (desc,) = take(1)
        kind = desc >> 6
        if kind == BT_CRC:
            break
        n = block_size if desc & 0x20 else int.from_bytes(take(2), "big")
        if not 0 < n <= block_size:
            raise FrameError("block size out of range")
        if kind == BT_COMPRESSED:
            blocks.append(("fse", take(int.from_bytes(take(2), "big")), n))
        elif kind == BT_RAW:
            blocks.append(("raw", take(n), n))
        else:
            blocks.append(("rle", take(1)[0], n))
    if len(buf) != pos + 2:
        raise FrameError("trailer truncated, or bytes after it")
    return blocks, (desc & 0x3F) << 16 | buf[pos] << 8 | buf[pos + 1]


def decode_table(norm: list[int], tlog: int) -> np.ndarray:
    """FSE_buildDTable: a cell's symbol | nbBits << 8 | newState << 16, for
    the 2^tlog cells (int64, padded to TABLE_CELLS)."""
    size = 1 << tlog
    counts = np.asarray(norm, np.int64)
    if tlog > MAX_TABLELOG or np.where(counts == -1, 1, counts).sum() != size:
        raise FrameError("normalized counts do not fill the table")
    low = np.flatnonzero(counts == -1)        # top cells, the first symbol highest
    high = size - 1 - len(low)
    symbol = np.empty(size, np.int64)
    symbol[size - 1 - np.arange(len(low))] = low
    # the spread visits (j * step) & mask for j = 0, 1, ..., skipping the
    # low-probability cells; step is odd, so every cell once
    step = (size >> 1) + (size >> 3) + 3
    cells = (np.arange(size) * step) & (size - 1)
    cells = cells[cells <= high]
    symbol[cells] = np.repeat(np.arange(len(counts)), np.maximum(counts, 0))
    # a symbol's cells in ascending order take next states count, count + 1, ...
    order = np.argsort(symbol, kind="stable")
    first = np.searchsorted(symbol[order], symbol[order])
    nxt = np.empty(size, np.int64)
    nxt[order] = np.arange(size) - first + np.maximum(counts, 1)[symbol[order]]
    nb = tlog - (np.floor(np.log2(nxt))).astype(np.int64)
    packed = np.zeros(TABLE_CELLS, np.int64)
    packed[:size] = symbol | nb << 8 | ((nxt << nb) - size) << 16
    return packed


def _block_inputs(payload: bytes) -> tuple[np.ndarray, bytes, int]:
    """(packed decode table, bitstream, tableLog) of a compressed block."""
    norm, _max_sv, tlog, used = read_ncount(payload)
    stream = payload[used:]
    if not stream or stream[-1] == 0:
        raise FrameError("bitstream empty or without its end mark")
    return decode_table(norm, tlog), stream, tlog


def _decode_batch(jobs: list[tuple], device) -> list[bytes | None]:
    """The bytes of each (packed table, stream, tableLog, n), or None where
    the bitstream's accounting fails."""
    B = len(jobs)
    L = max(len(s) for _t, s, _tl, _n in jobs)
    raw = np.zeros((B, L + 2), np.uint8)
    lens = np.array([len(s) for _t, s, _tl, _n in jobs], np.int64)
    for k, (_t, s, _tl, _n) in enumerate(jobs):
        raw[k, :len(s)] = np.frombuffer(s, np.uint8)
    last = raw[np.arange(B), lens - 1].astype(np.int64)
    # bits before the end mark; bit b is bit b % 8 of byte b // 8
    total = 8 * (lens - 1) + np.floor(np.log2(last)).astype(np.int64)

    def dev(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int64, device=device)

    r = torch.as_tensor(raw, device=device).to(torch.int32)
    win = r[:, :-2] | (r[:, 1:-1] << 8) | (r[:, 2:] << 16)  # 3 bytes from each byte
    del r
    table = dev(np.stack([t for t, _s, _tl, _n in jobs]))
    T, tl = dev(total), dev([j[2] for j in jobs])
    n = dev([j[3] for j in jobs])

    def read(used, nb):
        """nb bits ending `used` bits below the end mark (0 past the start)."""
        start = T - used
        w = torch.gather(win, 1, (start.clamp(min=0) >> 3)[:, None])[:, 0].long()
        return torch.where(start >= 0, (w >> (start.clamp(min=0) & 7))
                           & ((1 << nb) - 1), 0)

    used = tl.clone()
    states = [read(used, tl)]
    used = used + tl
    states.append(read(used, tl))
    N = int(n.max())
    syms = torch.empty((N, B), dtype=torch.uint8, device=device)
    used_after = torch.empty((N, B), dtype=torch.int32, device=device)
    for i in range(N):
        e = torch.gather(table, 1, states[i & 1][:, None])[:, 0]
        syms[i] = e & 0xFF
        nb = (e >> 8) & 0xFF
        used = used + nb
        used_after[i] = used
        states[i & 1] = (e >> 16) + read(used, nb)
    # the read after symbol n-2 is the first past the start: the one after
    # n-3 (the initial reads when n is 2) stays inside it
    cols = torch.arange(B, device=device)
    past = used_after[(n - 2).clamp(min=0), cols].long()
    before = torch.where(n >= 3, used_after[(n - 3).clamp(min=0), cols].long(), 2 * tl)
    ok = ((n >= 2) & (before <= T) & (past > T)).cpu().numpy()
    out = syms.T.cpu().numpy()
    return [out[k, :j[3]].tobytes() if ok[k] else None for k, j in enumerate(jobs)]


def decode_frames(frames: list[bytes], device="cpu") -> list[bytes | None]:
    """Each frame's decoded bytes, or None where the frame is not an `.fse`
    frame whose blocks decode and whose trailer matches what they give."""
    parsed: list[tuple | None] = []
    jobs, where = [], []                        # compressed blocks, (frame, block)
    for fi, f in enumerate(frames):
        try:
            blocks, crc = parse_frame(f)
            inputs = [_block_inputs(b[1]) if b[0] == "fse" else None for b in blocks]
        except FrameError:
            parsed.append(None)
            continue
        parsed.append((blocks, crc))
        for bi, (b, inp) in enumerate(zip(blocks, inputs)):
            if inp is not None:
                jobs.append((*inp, b[2]))
                where.append((fi, bi))
    pieces: dict[tuple[int, int], bytes | None] = {}
    for lo in range(0, len(jobs), MAX_BATCH_BLOCKS):
        pieces.update(zip(where[lo:lo + MAX_BATCH_BLOCKS],
                          _decode_batch(jobs[lo:lo + MAX_BATCH_BLOCKS], device)))
    out: list[bytes | None] = []
    for fi, p in enumerate(parsed):
        if p is None:
            out.append(None)
            continue
        blocks, crc = p
        chunks = [pieces[(fi, bi)] if kind == "fse" else
                  body if kind == "raw" else bytes([body]) * n
                  for bi, (kind, body, n) in enumerate(blocks)]
        if any(c is None for c in chunks):
            out.append(None)
            continue
        data = b"".join(chunks)
        out.append(data if (xxh32(data) >> 5) & 0x3FFFFF == crc else None)
    return out
