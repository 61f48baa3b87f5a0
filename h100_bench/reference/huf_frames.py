"""The plain reference for `fse -h` frames: a reader of `.fse` frames whose
blocks are Huff0-coded, written from the format alone (the reference's
programs/fileio.c, lib/huf_decompress.c, HUF_readStats in
lib/entropy_common.c, lib/bitstream.h and the XXH32 specification), in
plain PyTorch, numpy and Python, that shares no code with the program it
judges.

The frame is reference/fse_frames.py's with the magic 0x183E3309: a
blockSizeID byte, blocks led by a descriptor byte (compressed, raw, RLE;
a partial block gives its size), and a trailer with the 22-bit XXH32 of
the decoded data.  A compressed block's payload of c bytes regenerates n:
c == n is the bytes as they are, c == 1 a run of its one byte, c > n is
corrupt (HUF_decompress); else it is a weight header, a jump table and
four streams.

The weight header (HUF_readStats): a first byte b >= 128 is followed by
b - 127 weights, two 4-bit weights a byte, high nibble first; a smaller b
is the size of an FSE-coded weight stream (an NCount of tableLog <= 6,
then a bitstream of two interleaved states) whose number of weights is
not stored: the decoder stops at the first state update whose read runs
past the stream's start and emits one more weight, from the other state
(FSE_decompress_usingDTable_generic).  Each weight is < 12; the weight of
the last symbol is implied: with total = sum of 2^(w-1) over the weights
given, tableLog = highbit(total) + 1 <= 12, and 2^tableLog - total must be
a power of two, 2^(w_last - 1).  The weight-1 symbols are even in number
and at least two.

The X1 table has 2^tableLog cells: the symbols of weight 1, then of weight
2, ..., each in symbol order, symbol s taking 2^(w-1) cells of nbBits =
tableLog + 1 - w.  A lookup reads the next tableLog bits of a stream (zeros
past its start) and consumes the cell's nbBits.

The jump table is three little-endian u16 sizes of the first three
streams; the fourth takes the rest.  Stream k < 3 regenerates seg = (n +
3) / 4 bytes, the fourth n - 3 seg.  Each stream is a bitstream read
backward from its last byte, whose highest set bit marks its end, and
decodes only if its symbols consume exactly its bits.

Every stream of every compressed block of the frames decodes in one batch
on the given device, one symbol a stream a step.
"""
from __future__ import annotations

import numpy as np
import torch

from h100_bench.reference.fse_frames import decode_table, xxh32
from h100_bench.reference.ncount import FrameError, read_ncount

MAGIC = 0x183E3309
BT_COMPRESSED, BT_RAW, BT_RLE, BT_CRC = 0, 1, 2, 3
MAX_BLOCK_SIZE_ID = 6
TABLELOG_MAX = 12             # HUF_TABLELOG_MAX: weights below it, tableLog at most it
WEIGHT_TABLELOG_MAX = 6       # the FSE-coded weights' tableLog
MAX_WEIGHTS = 255             # weights a header can give (the last symbol's implied)
TABLE_CELLS = 1 << TABLELOG_MAX
MAX_BATCH_BLOCKS = 2048       # blocks decoded together (bounds device memory)
PAD = 2                       # zero bytes below each stream: a lookup past its start reads 0


def parse_frame(buf: bytes) -> tuple[list[tuple], int]:
    """([("huf", payload, n) | ("raw", bytes, n) | ("rle", byte, n)], the
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
            payload = take(int.from_bytes(take(2), "big"))
            if len(payload) > n:
                raise FrameError("payload larger than its block")
            blocks.append(("raw", payload, n) if len(payload) == n else
                          ("rle", payload[0], n) if len(payload) == 1 else
                          ("huf", payload, n))
        elif kind == BT_RAW:
            blocks.append(("raw", take(n), n))
        else:
            blocks.append(("rle", take(1)[0], n))
    if len(buf) != pos + 2:
        raise FrameError("trailer truncated, or bytes after it")
    return blocks, (desc & 0x3F) << 16 | buf[pos] << 8 | buf[pos + 1]


def _bits(stream: bytes) -> int:
    """The stream's bits below its end mark."""
    if not stream or stream[-1] == 0:
        raise FrameError("bitstream empty or without its end mark")
    return 8 * (len(stream) - 1) + stream[-1].bit_length() - 1


def fse_weights(src: bytes) -> list[int]:
    """The weights of an FSE-coded weight stream (NCount, then the states'
    bitstream), as many as the decoder's end rule gives."""
    norm, _max_sv, tlog, used = read_ncount(src)
    if tlog > WEIGHT_TABLELOG_MAX:
        raise FrameError("weights' tableLog too large")
    if used >= len(src):
        raise FrameError("no weight bitstream")
    table = decode_table(norm, tlog).tolist()
    total = _bits(src[used:])
    v = int.from_bytes(src[used:], "little")

    def read(consumed: int, nb: int) -> int:
        """nb bits ending `consumed` bits below the end mark (0 past the start)."""
        start = total - consumed
        return ((v >> start) if start >= 0 else (v << -start)) & ((1 << nb) - 1)

    consumed = 2 * tlog
    if consumed > total:
        raise FrameError("weight bitstream shorter than its states")
    states = [read(tlog, tlog), read(consumed, tlog)]
    out: list[int] = []
    while True:
        k = len(out) & 1
        e = table[states[k]]
        out.append(e & 0xFF)
        nb = (e >> 8) & 0xFF
        consumed += nb
        states[k] = (e >> 16) + read(consumed, nb)
        if consumed > total:
            out.append(table[states[k ^ 1]] & 0xFF)
            return out
        if len(out) >= MAX_WEIGHTS - 1:
            raise FrameError("too many weights")


def read_weights(payload: bytes) -> tuple[list[int], int, int]:
    """(a weight for every symbol up to the last, the implied last one
    included; tableLog; header bytes) of a compressed block's payload."""
    b = payload[0]
    if b >= 128:
        count = b - 127
        size = (count + 1) // 2
        if size + 1 > len(payload):
            raise FrameError("weight header truncated")
        weights = [x for byte in payload[1:1 + size] for x in (byte >> 4, byte & 15)][:count]
    else:
        size = b
        if size + 1 > len(payload):
            raise FrameError("weight header truncated")
        weights = fse_weights(payload[1:1 + size])
    if max(weights) >= TABLELOG_MAX:
        raise FrameError("weight out of range")
    total = sum((1 << w) >> 1 for w in weights)
    if total == 0:
        raise FrameError("no weights")
    tlog = total.bit_length()
    rest = (1 << tlog) - total
    if tlog > TABLELOG_MAX or rest & (rest - 1):
        raise FrameError("the implied weight is not a power of two")
    weights.append(rest.bit_length())
    ones = weights.count(1)
    if ones < 2 or ones & 1:
        raise FrameError("weight-1 symbols not even and at least two")
    return weights, tlog, size + 1


def x1_table(weights: list[int], tlog: int) -> np.ndarray:
    """HUF_readDTableX1: a cell's symbol | nbBits << 8, for the 2^tlog cells
    (int32, padded to TABLE_CELLS)."""
    w = np.asarray(weights, np.int64)
    present = np.flatnonzero(w)
    order = present[np.argsort(w[present], kind="stable")]  # by weight, then symbol
    cells = (1 << w[order]) >> 1
    packed = np.zeros(TABLE_CELLS, np.int32)
    packed[:1 << tlog] = np.repeat(order | (tlog + 1 - w[order]) << 8, cells)
    return packed


def _block_inputs(payload: bytes, n: int) -> tuple[np.ndarray, int, list[tuple]]:
    """(X1 table, tableLog, [(stream, its bits, symbols)] of the four
    streams) of a Huff0 block of n bytes."""
    weights, tlog, used = read_weights(payload)
    body = payload[used:]
    if len(body) < 10:
        raise FrameError("streams shorter than a jump table and a byte each")
    sizes = [int.from_bytes(body[2 * k:2 * k + 2], "little") for k in range(3)]
    sizes.append(len(body) - 6 - sum(sizes))
    seg = (n + 3) // 4
    if sizes[3] < 0 or n < 3 * seg:
        raise FrameError("jump table past the payload, or a block too short")
    streams, pos = [], 6
    for k, size in enumerate(sizes):
        stream = body[pos:pos + size]
        streams.append((stream, _bits(stream), seg if k < 3 else n - 3 * seg))
        pos += size
    return x1_table(weights, tlog), tlog, streams


def _decode_batch(jobs: list[tuple], device) -> list[bytes | None]:
    """The bytes of each (X1 table, tableLog, four (stream, its bits,
    symbols)), or None where a stream's accounting fails."""
    rows = [(b, *st) for b, (_t, _tl, streams) in enumerate(jobs) for st in streams]
    R = len(rows)
    raw = np.zeros((R, max(len(s) for _b, s, _t, _n in rows) + 2 * PAD), np.uint8)
    for k, (_b, s, _t, _n) in enumerate(rows):
        raw[k, PAD:PAD + len(s)] = np.frombuffer(s, np.uint8)
    blk, total, n = (np.array([row[c] for row in rows], np.int64) for c in (0, 2, 3))
    tlog = np.array([j[1] for j in jobs], np.int64)[blk]

    def dev(a, dtype=torch.int64):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    r = dev(raw, torch.int32)
    win = r[:, :-2] | (r[:, 1:-1] << 8) | (r[:, 2:] << 16)  # 3 bytes from each byte
    del r
    # a lookup after `used` bits reads tlog bits from bit top - used of the
    # padded row (each row's end mark sits at total + 8 PAD)
    top = dev(total + 8 * PAD - tlog)
    mask = dev((1 << tlog) - 1)
    table = dev(np.concatenate([np.stack([j[0] for j in jobs]),
                                np.zeros((1, TABLE_CELLS), np.int32)]).reshape(-1))
    base = dev(blk * TABLE_CELLS)
    done_base = len(jobs) * TABLE_CELLS   # the zero table: no symbol, no bits
    ends: dict[int, list[int]] = {}
    for k, m in enumerate(n.tolist()):
        ends.setdefault(m, []).append(k)
    used = torch.zeros(R, dtype=torch.int64, device=device)
    N = int(n.max())
    syms = torch.empty((N, R), dtype=torch.uint8, device=device)
    for i in range(N):
        if i in ends:                     # rows whose symbols are all out
            base[dev(ends[i])] = done_base
        s = (top - used).clamp_(min=0)
        w = torch.gather(win, 1, (s >> 3)[:, None])[:, 0]
        e = table[base + ((w >> (s & 7)) & mask)]
        syms[i] = e & 0xFF
        used += e >> 8
    ok = (used == dev(total)).cpu().numpy()
    out = syms.T.cpu().numpy()
    rows_out = [out[k, :m].tobytes() if ok[k] else None for k, m in enumerate(n.tolist())]
    blocks = [rows_out[4 * b:4 * b + 4] for b in range(len(jobs))]
    return [None if None in parts else b"".join(parts) for parts in blocks]


def decode_frames(frames: list[bytes], device="cpu") -> list[bytes | None]:
    """Each frame's decoded bytes, or None where the frame is not an `fse
    -h` frame whose blocks decode and whose trailer matches what they give."""
    parsed: list[tuple | None] = []
    jobs, where = [], []                        # Huff0 blocks, (frame, block)
    for fi, f in enumerate(frames):
        try:
            blocks, crc = parse_frame(f)
            inputs = [_block_inputs(b[1], b[2]) if b[0] == "huf" else None for b in blocks]
        except FrameError:
            parsed.append(None)
            continue
        parsed.append((blocks, crc))
        for bi, inp in enumerate(inputs):
            if inp is not None:
                jobs.append(inp)
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
        chunks = [pieces[(fi, bi)] if kind == "huf" else
                  body if kind == "raw" else bytes([body]) * n
                  for bi, (kind, body, n) in enumerate(blocks)]
        if any(c is None for c in chunks):
            out.append(None)
            continue
        data = b"".join(chunks)
        out.append(data if (xxh32(data) >> 5) & 0x3FFFFF == crc else None)
    return out
