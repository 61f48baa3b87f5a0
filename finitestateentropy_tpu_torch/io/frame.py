"""Frame format — byte-compatible with reference programs/fileio.c:267-285.

Layout: MAGIC(4B LE, per codec) + blockSizeID(1B) + per block
[1B type/fullBlock descriptor (+2B BE regenerated size if partial)
 (+2B BE compressed size if compressed)] + payload, terminated by a 3-byte
trailer carrying a 22-bit checksum (XXH32(original) >> 5).

The codec is *batch oriented*: the frame layer extracts all blocks, hands the
whole batch to a codec (host twin or TPU batched pipeline), and reassembles
frames in input order — this is the host<->device boundary (the reference
crosses into the codec per block at fileio.c:343; we cross once per batch).
"""
from __future__ import annotations

from typing import Callable, Iterable, Sequence

from ..config import (
    BT_COMPRESSED,
    BT_CRC,
    BT_RAW,
    BT_RLE,
    FIO_BLOCKSIZEID_DEFAULT,
    FIO_MAGIC_FSE,
    FIO_MAGIC_HUF,
    FIO_MAGIC_ZLIBH,
    FIO_MAX_BLOCKSIZE_ID,
    FSE_CHECKSUM_SEED,
)
from ..errors import CorruptionError, FSEError, GENERIC
from ..refimpl.blocktypes import BlockResult, Kind
from ..utils.xxhash32 import xxh32

MAGIC_BY_CODEC = {"fse": FIO_MAGIC_FSE, "huf": FIO_MAGIC_HUF, "zlibh": FIO_MAGIC_ZLIBH}
CODEC_BY_MAGIC = {v: k for k, v in MAGIC_BY_CODEC.items()}

# codec callables are batch-level: list[bytes] -> list[BlockResult]
BatchCompressor = Callable[[Sequence[bytes]], Sequence[BlockResult]]
BatchDecompressor = Callable[[Sequence[tuple[bytes, int]]], Sequence[bytes]]


def _host_batch_compressor(codec: str) -> BatchCompressor:
    if codec == "fse":
        from ..refimpl.fse import fse_compress

        return lambda blocks: [fse_compress(b) for b in blocks]
    if codec == "huf":
        from ..refimpl.huf import huf_compress

        return lambda blocks: [huf_compress(b) for b in blocks]
    if codec == "zlibh":
        from ..refimpl.blocktypes import BlockResult
        from ..refimpl.zlibh import zlibh_compress

        # ZLIBH_compress never signals raw/rle (fileio.c:347-349 applies
        # those only to return codes 0/1), so every block is "compressed"
        return lambda blocks: [BlockResult.compressed(zlibh_compress(b))
                               for b in blocks]
    raise FSEError(GENERIC, f"unsupported codec: {codec}")


def _host_batch_decompressor(codec: str) -> BatchDecompressor:
    if codec == "fse":
        from ..refimpl.fse import fse_decompress

        return lambda items: [fse_decompress(c, n) for c, n in items]
    if codec == "huf":
        from ..refimpl.huf import huf_decompress

        return lambda items: [huf_decompress(c, n) for c, n in items]
    if codec == "zlibh":
        from ..refimpl.zlibh import zlibh_decompress

        return lambda items: [zlibh_decompress(c, n) for c, n in items]
    raise FSEError(GENERIC, f"unsupported codec: {codec}")


def split_blocks(data: bytes, block_size: int) -> list[bytes]:
    return [data[i : i + block_size] for i in range(0, len(data), block_size)]


def compress_bytes(
    data: bytes,
    codec: str = "fse",
    block_size_id: int = FIO_BLOCKSIZEID_DEFAULT,
    compressor: BatchCompressor | None = None,
) -> bytes:
    """Compress a whole buffer into a frame (identical bytes to the ref CLI)."""
    if block_size_id > FIO_MAX_BLOCKSIZE_ID:
        raise FSEError(GENERIC, "block size id too large")
    block_size = 1 << (10 + block_size_id)
    if compressor is None:
        compressor = _host_batch_compressor(codec)

    out = bytearray()
    out += MAGIC_BY_CODEC[codec].to_bytes(4, "little")
    out.append(block_size_id)

    blocks = split_blocks(data, block_size)
    results = compressor(blocks)
    for chunk, r in zip(blocks, results):
        full = len(chunk) == block_size
        if r.kind == Kind.COMPRESSED:
            c = r.data
            if full:
                out += bytes([(BT_COMPRESSED << 6) + 0x20, len(c) >> 8, len(c) & 0xFF])
            else:
                out += bytes(
                    [
                        BT_COMPRESSED << 6,
                        len(chunk) >> 8,
                        len(chunk) & 0xFF,
                        len(c) >> 8,
                        len(c) & 0xFF,
                    ]
                )
            out += c
        elif r.kind == Kind.RAW:
            if full:
                out += bytes([(BT_RAW << 6) + 0x20])
            else:
                out += bytes([BT_RAW << 6, len(chunk) >> 8, len(chunk) & 0xFF])
            out += chunk
        else:  # RLE
            if full:
                out += bytes([(BT_RLE << 6) + 0x20])
            else:
                out += bytes([BT_RLE << 6, len(chunk) >> 8, len(chunk) & 0xFF])
            out.append(chunk[0])

    crc = (xxh32(data, FSE_CHECKSUM_SEED) >> 5) & ((1 << 22) - 1)
    out += bytes([(crc >> 16) + (BT_CRC << 6), (crc >> 8) & 0xFF, crc & 0xFF])
    return bytes(out)


def decompress_bytes(frame: bytes, decompressor: BatchDecompressor | None = None) -> bytes:
    """Decompress a frame; verifies the 22-bit trailer checksum."""
    if len(frame) < 8:
        raise CorruptionError("frame too small")
    magic = int.from_bytes(frame[0:4], "little")
    codec = CODEC_BY_MAGIC.get(magic)
    if codec is None:
        raise CorruptionError("unknown magic number")
    block_size_id = frame[4]
    if block_size_id > FIO_MAX_BLOCKSIZE_ID:
        raise CorruptionError("unknown blockSizeID")
    block_size = 1 << (10 + block_size_id)
    if decompressor is None:
        decompressor = _host_batch_decompressor(codec)

    pos = 5
    todo: list[tuple[bytes, int]] = []   # compressed blocks for the batch codec
    plan: list[tuple[int, object]] = []  # (btype, payload-or-index)
    while True:
        if pos >= len(frame):
            raise CorruptionError("missing frame trailer")
        desc = frame[pos]
        btype = desc >> 6
        if btype == BT_CRC:
            break
        full = bool(desc & 0x20)
        pos += 1
        rsize = block_size
        if not full:
            rsize = (frame[pos] << 8) | frame[pos + 1]
            pos += 2
        if btype == BT_COMPRESSED:
            csize = (frame[pos] << 8) | frame[pos + 1]
            pos += 2
            plan.append((btype, len(todo)))
            todo.append((frame[pos : pos + csize], rsize))
        elif btype == BT_RAW:
            csize = rsize
            plan.append((btype, frame[pos : pos + csize]))
        elif btype == BT_RLE:
            csize = 1
            plan.append((btype, (frame[pos], rsize)))
        else:
            raise CorruptionError("bad block type")
        pos += csize

    decoded = decompressor(todo) if todo else []
    out = bytearray()
    for btype, info in plan:
        if btype == BT_COMPRESSED:
            out += decoded[info]
        elif btype == BT_RAW:
            out += info
        else:
            byte, rsize = info
            out += bytes([byte]) * rsize

    saved = frame[pos + 2] + (frame[pos + 1] << 8) + ((frame[pos] & 0x3F) << 16)
    calc = (xxh32(bytes(out), FSE_CHECKSUM_SEED) >> 5) & ((1 << 22) - 1)
    if saved != calc:
        raise CorruptionError("frame checksum mismatch")
    return bytes(out)


def compress_file(src_path, dst_path, codec="fse", block_size_id=FIO_BLOCKSIZEID_DEFAULT,
                  compressor: BatchCompressor | None = None) -> tuple[int, int]:
    with open(src_path, "rb") as f:
        data = f.read()
    frame = compress_bytes(data, codec, block_size_id, compressor)
    with open(dst_path, "wb") as f:
        f.write(frame)
    return len(data), len(frame)


def decompress_file(src_path, dst_path, decompressor: BatchDecompressor | None = None) -> int:
    with open(src_path, "rb") as f:
        frame = f.read()
    data = decompress_bytes(frame, decompressor)
    with open(dst_path, "wb") as f:
        f.write(data)
    return len(data)
