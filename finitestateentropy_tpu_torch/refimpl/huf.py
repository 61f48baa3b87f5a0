"""Huff0 (canonical Huffman, 4-stream) — host-exact twin.

Mirrors reference lib/huf_compress.c and lib/huf_decompress.c:
tree build with counting sort + Kraft-debt length limiting (huf_compress.c:
208-439), FSE-compressed weight header (:57-205), 4-stream interleaved
encode with LE16 jump table (:443-798), single-symbol (X1) and double-symbol
(X2) decoders (huf_decompress.c:111-953), and the empirical decoder selector
(:1000-1081).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..config import (
    HUF_SYMBOLVALUE_MAX,
    HUF_TABLELOG_DEFAULT,
    HUF_TABLELOG_MAX,
    huf_compressbound,
)
from ..errors import (
    CorruptionError,
    FSEError,
    GENERIC,
    MAX_SYMBOL_VALUE_TOO_LARGE,
    SRC_SIZE_WRONG,
    TABLELOG_TOO_LARGE,
)
from .bitstream import BitReader, BitWriter, UNFINISHED, highbit32
from .blocktypes import BlockResult, Kind
from .fse import fse_compress_using_ctable, fse_decompress_using_dtable
from .hist import hist_count
from .ncount import fse_read_ncount, fse_write_ncount
from .norm import fse_normalize_count, fse_optimal_table_log
from .tables import build_ctable, build_dtable


# ---------------------------------------------------------------------------
# Tree build
# ---------------------------------------------------------------------------


def _huf_sort(count, max_symbol_value: int):
    """Counting sort by log2-rank with insertion within rank (huf_compress.c:307-329).

    Returns (node_count, node_byte) arrays, descending by count.
    """
    n_sym = max_symbol_value + 1
    base = np.zeros(32, dtype=np.int64)
    for n in range(n_sym):
        base[highbit32(int(count[n]) + 1)] += 1
    for n in range(30, 0, -1):
        base[n - 1] += base[n]
    current = base.copy()
    node_count = np.zeros(n_sym, dtype=np.int64)
    node_byte = np.zeros(n_sym, dtype=np.int64)
    for n in range(n_sym):
        c = int(count[n])
        r = highbit32(c + 1) + 1
        pos = int(current[r])
        current[r] += 1
        while pos > base[r] and c > node_count[pos - 1]:
            node_count[pos] = node_count[pos - 1]
            node_byte[pos] = node_byte[pos - 1]
            pos -= 1
        node_count[pos] = c
        node_byte[pos] = n
    return node_count, node_byte


def _set_max_height(nb_bits, counts, last_non_null: int, max_nb_bits: int) -> int:
    """Kraft-debt repayment length limiting (huf_compress.c:215-291)."""
    largest_bits = int(nb_bits[last_non_null])
    if largest_bits <= max_nb_bits:
        return largest_bits

    NO_SYMBOL = 0xF0F0F0F0
    total_cost = 0
    base_cost = 1 << (largest_bits - max_nb_bits)
    # (the reference walks onto a zero-nbBits sentinel below index 0; the
    #  n >= 0 guards here are equivalent)
    n = last_non_null
    while n >= 0 and nb_bits[n] > max_nb_bits:
        total_cost += base_cost - (1 << (largest_bits - int(nb_bits[n])))
        nb_bits[n] = max_nb_bits
        n -= 1
    while n >= 0 and nb_bits[n] == max_nb_bits:
        n -= 1

    total_cost >>= largest_bits - max_nb_bits

    rank_last = [NO_SYMBOL] * (HUF_TABLELOG_MAX + 2)
    current_nb_bits = max_nb_bits
    for pos in range(n, -1, -1):
        if nb_bits[pos] >= current_nb_bits:
            continue
        current_nb_bits = int(nb_bits[pos])
        rank_last[max_nb_bits - current_nb_bits] = pos

    while total_cost > 0:
        n_bits_to_decrease = highbit32(total_cost) + 1
        while n_bits_to_decrease > 1:
            high_pos = rank_last[n_bits_to_decrease]
            low_pos = rank_last[n_bits_to_decrease - 1]
            if high_pos == NO_SYMBOL:
                n_bits_to_decrease -= 1
                continue
            if low_pos == NO_SYMBOL:
                break
            if int(counts[high_pos]) <= 2 * int(counts[low_pos]):
                break
            n_bits_to_decrease -= 1
        while n_bits_to_decrease <= HUF_TABLELOG_MAX and rank_last[n_bits_to_decrease] == NO_SYMBOL:
            n_bits_to_decrease += 1
        total_cost -= 1 << (n_bits_to_decrease - 1)
        if rank_last[n_bits_to_decrease - 1] == NO_SYMBOL:
            rank_last[n_bits_to_decrease - 1] = rank_last[n_bits_to_decrease]
        nb_bits[rank_last[n_bits_to_decrease]] += 1
        if rank_last[n_bits_to_decrease] == 0:
            rank_last[n_bits_to_decrease] = NO_SYMBOL
        else:
            rank_last[n_bits_to_decrease] -= 1
            if nb_bits[rank_last[n_bits_to_decrease]] != max_nb_bits - n_bits_to_decrease:
                rank_last[n_bits_to_decrease] = NO_SYMBOL

    while total_cost < 0:  # overshoot repair
        if rank_last[1] == NO_SYMBOL:
            while n >= 0 and nb_bits[n] == max_nb_bits:
                n -= 1
            nb_bits[n + 1] -= 1
            rank_last[1] = n + 1
            total_cost += 1
            continue
        nb_bits[rank_last[1] + 1] -= 1
        rank_last[1] += 1
        total_cost += 1

    return max_nb_bits


@dataclasses.dataclass
class HufCTable:
    nb_bits: np.ndarray  # uint8[256]
    val: np.ndarray      # uint16[256]
    max_nb_bits: int


def huf_build_ctable(count, max_symbol_value: int, max_nb_bits: int = HUF_TABLELOG_DEFAULT) -> HufCTable:
    """huf_compress.c:338-410."""
    if max_nb_bits == 0:
        max_nb_bits = HUF_TABLELOG_DEFAULT
    if max_symbol_value > HUF_SYMBOLVALUE_MAX:
        raise FSEError(MAX_SYMBOL_VALUE_TOO_LARGE)

    STARTNODE = HUF_SYMBOLVALUE_MAX + 1
    SIZE = 2 * HUF_SYMBOLVALUE_MAX + 2
    node_count = np.zeros(SIZE + 1, dtype=np.int64)  # +1: fake barrier at index 0
    node_byte = np.zeros(SIZE + 1, dtype=np.int64)
    node_parent = np.zeros(SIZE + 1, dtype=np.int64)
    node_nbbits = np.zeros(SIZE + 1, dtype=np.int64)
    # index 0 is the sentinel "huffNode0[0]"; logical node i lives at i+1
    sc, sb = _huf_sort(count, max_symbol_value)
    node_count[1 : 1 + sc.size] = sc
    node_byte[1 : 1 + sb.size] = sb

    def C(i):  # logical accessor
        return int(node_count[i + 1])

    non_null_rank = max_symbol_value
    while C(non_null_rank) == 0:
        non_null_rank -= 1
    low_s = non_null_rank
    node_nb = STARTNODE
    node_root = node_nb + low_s - 1
    low_n = node_nb
    node_count[node_nb + 1] = C(low_s) + C(low_s - 1)
    node_parent[low_s + 1] = node_parent[low_s - 1 + 1] = node_nb
    node_nb += 1
    low_s -= 2
    for n in range(node_nb, node_root + 1):
        node_count[n + 1] = 1 << 30
    node_count[0] = 1 << 31  # barrier

    while node_nb <= node_root:
        if C(low_s) < C(low_n):
            n1 = low_s
            low_s -= 1
        else:
            n1 = low_n
            low_n += 1
        if C(low_s) < C(low_n):
            n2 = low_s
            low_s -= 1
        else:
            n2 = low_n
            low_n += 1
        node_count[node_nb + 1] = C(n1) + C(n2)
        node_parent[n1 + 1] = node_parent[n2 + 1] = node_nb
        node_nb += 1

    node_nbbits[node_root + 1] = 0
    for n in range(node_root - 1, STARTNODE - 1, -1):
        node_nbbits[n + 1] = node_nbbits[node_parent[n + 1] + 1] + 1
    for n in range(non_null_rank + 1):
        node_nbbits[n + 1] = node_nbbits[node_parent[n + 1] + 1] + 1

    leaf_bits = node_nbbits[1 : non_null_rank + 2]
    leaf_counts = node_count[1 : non_null_rank + 2]
    max_nb_bits = _set_max_height(leaf_bits, leaf_counts, non_null_rank, max_nb_bits)

    if max_nb_bits > HUF_TABLELOG_MAX:
        raise FSEError(GENERIC, "huffman tree too deep")

    nb_per_rank = np.zeros(HUF_TABLELOG_MAX + 1, dtype=np.int64)
    val_per_rank = np.zeros(HUF_TABLELOG_MAX + 1, dtype=np.int64)
    for n in range(non_null_rank + 1):
        nb_per_rank[leaf_bits[n]] += 1
    mn = 0
    for n in range(max_nb_bits, 0, -1):
        val_per_rank[n] = mn
        mn += nb_per_rank[n]
        mn >>= 1

    tree_nbbits = np.zeros(max_symbol_value + 1, dtype=np.uint8)
    tree_val = np.zeros(max_symbol_value + 1, dtype=np.uint16)
    for n in range(max_symbol_value + 1):
        tree_nbbits[node_byte[n + 1]] = node_nbbits[n + 1]
    vpr = val_per_rank.copy()
    for n in range(max_symbol_value + 1):
        tree_val[n] = vpr[tree_nbbits[n]]
        vpr[tree_nbbits[n]] += 1
    return HufCTable(tree_nbbits, tree_val, max_nb_bits)


def huf_estimate_compressed_size(ct: HufCTable, count) -> int:
    n = min(len(count), len(ct.nb_bits))
    return int(np.dot(ct.nb_bits[:n].astype(np.int64), np.asarray(count[:n], dtype=np.int64))) >> 3


def huf_validate_ctable(ct: HufCTable, count) -> bool:
    n = min(len(count), len(ct.nb_bits))
    c = np.asarray(count[:n], dtype=np.int64)
    return not bool(np.any((c != 0) & (ct.nb_bits[:n] == 0)))


# ---------------------------------------------------------------------------
# Weight header
# ---------------------------------------------------------------------------

_MAX_FSE_TABLELOG_FOR_HUFF_HEADER = 6


def _huf_compress_weights(weights: bytes) -> BlockResult:
    """FSE-compress the weight table (huf_compress.c:63-103)."""
    wt_size = len(weights)
    if wt_size <= 1:
        return BlockResult.raw()
    count, max_sv, max_count = hist_count(weights, HUF_TABLELOG_MAX)
    if max_count == wt_size:
        return BlockResult.rle()
    if max_count == 1:
        return BlockResult.raw()
    table_log = fse_optimal_table_log(_MAX_FSE_TABLELOG_FOR_HUFF_HEADER, wt_size, max_sv)
    norm, table_log = fse_normalize_count(table_log, count, wt_size, max_sv)
    if norm is None:
        return BlockResult.rle()
    header = fse_write_ncount(norm, max_sv, table_log)
    ct = build_ctable(norm, max_sv, table_log)
    payload = fse_compress_using_ctable(weights, ct)
    if not payload:
        return BlockResult.raw()
    return BlockResult.compressed(header + payload)


def huf_write_ctable(ct: HufCTable, max_symbol_value: int) -> bytes:
    """huf_compress.c:114-147. Last weight is implied and not stored."""
    huff_log = ct.max_nb_bits
    bits_to_weight = np.zeros(HUF_TABLELOG_MAX + 1, dtype=np.uint8)
    for n in range(1, huff_log + 1):
        bits_to_weight[n] = huff_log + 1 - n
    weights = bytes(bits_to_weight[ct.nb_bits[n]] for n in range(max_symbol_value))

    r = _huf_compress_weights(weights)
    if r.kind == Kind.COMPRESSED and 1 < len(r.data) < max_symbol_value // 2:
        return bytes([len(r.data)]) + r.data

    # raw 4-bit nibbles
    if max_symbol_value > 256 - 128:
        raise FSEError(GENERIC, "weights not storable raw")
    out = bytearray([128 + (max_symbol_value - 1)])
    w = weights + b"\x00"
    for n in range(0, max_symbol_value, 2):
        out.append((w[n] << 4) + w[n + 1])
    return bytes(out)


def huf_read_stats(src: bytes, max_weights: int = HUF_SYMBOLVALUE_MAX + 1):
    """entropy_common.c:154-215.

    Returns (weights bytes, rank_stats[HUF_TABLELOG_MAX+1], nb_symbols,
    table_log, bytes_consumed).
    """
    if not src:
        raise FSEError(SRC_SIZE_WRONG)
    i_size = src[0]
    if i_size >= 128:  # raw nibbles
        o_size = i_size - 127
        i_size = (o_size + 1) // 2
        if i_size + 1 > len(src):
            raise FSEError(SRC_SIZE_WRONG)
        if o_size >= max_weights:
            raise CorruptionError("too many weights")
        body = src[1 : 1 + i_size]
        weights = bytearray()
        for b in body:
            weights.append(b >> 4)
            weights.append(b & 15)
        weights = weights[:o_size] if o_size % 2 == 0 else weights[: o_size]
        # note: C reads pairs; odd o_size keeps the high nibble of last byte
        weights = bytearray(weights[:o_size])
    else:  # FSE-compressed weights
        if i_size + 1 > len(src):
            raise FSEError(SRC_SIZE_WRONG)
        norm, max_sv, table_log, used = fse_read_ncount(src[1 : 1 + i_size])
        if table_log > _MAX_FSE_TABLELOG_FOR_HUFF_HEADER:
            raise FSEError(TABLELOG_TOO_LARGE)
        dt = build_dtable(norm, max_sv, table_log)
        weights = bytearray(
            fse_decompress_using_dtable(src[1 + used : 1 + i_size], dt, max_weights - 1)
        )
        o_size = len(weights)

    rank_stats = np.zeros(HUF_TABLELOG_MAX + 1, dtype=np.int64)
    weight_total = 0
    for wgt in weights[:o_size]:
        if wgt >= HUF_TABLELOG_MAX:
            raise CorruptionError("weight out of range")
        rank_stats[wgt] += 1
        weight_total += (1 << wgt) >> 1
    if weight_total == 0:
        raise CorruptionError("empty weights")

    table_log = highbit32(weight_total) + 1
    if table_log > HUF_TABLELOG_MAX:
        raise CorruptionError("weight total too large")
    total = 1 << table_log
    rest = total - weight_total
    verif = 1 << highbit32(rest)
    last_weight = highbit32(rest) + 1
    if verif != rest:
        raise CorruptionError("implied weight not a power of 2")
    weights = bytes(weights[:o_size]) + bytes([last_weight])
    rank_stats[last_weight] += 1

    if rank_stats[1] < 2 or rank_stats[1] & 1:
        raise CorruptionError("invalid rank-1 count")

    return weights, rank_stats, o_size + 1, table_log, i_size + 1


def huf_read_ctable(src: bytes, max_symbol_value: int = HUF_SYMBOLVALUE_MAX):
    """huf_compress.c:150-198. Returns (HufCTable, nb_symbols-1, consumed)."""
    weights, rank_stats, nb_symbols, table_log, used = huf_read_stats(src)
    if table_log > HUF_TABLELOG_MAX:
        raise FSEError(TABLELOG_TOO_LARGE)
    if nb_symbols > max_symbol_value + 1:
        raise FSEError(MAX_SYMBOL_VALUE_TOO_LARGE)

    nb_bits = np.zeros(nb_symbols, dtype=np.uint8)
    for n in range(nb_symbols):
        w = weights[n]
        nb_bits[n] = (table_log + 1 - w) if w != 0 else 0

    nb_per_rank = np.zeros(HUF_TABLELOG_MAX + 2, dtype=np.int64)
    for n in range(nb_symbols):
        nb_per_rank[nb_bits[n]] += 1
    val_per_rank = np.zeros(HUF_TABLELOG_MAX + 2, dtype=np.int64)
    mn = 0
    for n in range(table_log, 0, -1):
        val_per_rank[n] = mn
        mn += nb_per_rank[n]
        mn >>= 1
    val = np.zeros(nb_symbols, dtype=np.uint16)
    for n in range(nb_symbols):
        val[n] = val_per_rank[nb_bits[n]]
        val_per_rank[nb_bits[n]] += 1
    return HufCTable(nb_bits, val, table_log), nb_symbols - 1, used


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------


def huf_compress_1x_using_ctable(src: bytes, ct: HufCTable, dst_capacity: int) -> bytes:
    """huf_compress.c:457-502 (64-bit flush cadence: 4 symbols per flush)."""
    if dst_capacity < 8:
        return b""
    try:
        w = BitWriter(dst_capacity)
    except ValueError:
        return b""
    nb, val = ct.nb_bits, ct.val
    src_size = len(src)
    n = src_size & ~3
    rem = src_size & 3
    if rem >= 3:
        w.add_bits(int(val[src[n + 2]]), int(nb[src[n + 2]]))
    if rem >= 2:
        w.add_bits(int(val[src[n + 1]]), int(nb[src[n + 1]]))
    if rem >= 1:
        w.add_bits(int(val[src[n + 0]]), int(nb[src[n + 0]]))
        w.flush()
    while n > 0:
        w.add_bits(int(val[src[n - 1]]), int(nb[src[n - 1]]))
        w.add_bits(int(val[src[n - 2]]), int(nb[src[n - 2]]))
        w.add_bits(int(val[src[n - 3]]), int(nb[src[n - 3]]))
        w.add_bits(int(val[src[n - 4]]), int(nb[src[n - 4]]))
        w.flush()
        n -= 4
    size = w.close()
    return w.bytes(size) if size else b""


def huf_compress_4x_using_ctable(src: bytes, ct: HufCTable, dst_capacity: int) -> bytes:
    """4 independent streams + 6-byte LE16 jump table (huf_compress.c:552-603)."""
    src_size = len(src)
    if dst_capacity < 6 + 1 + 1 + 1 + 8:
        return b""
    if src_size < 12:
        return b""
    segment = (src_size + 3) // 4
    out = bytearray()
    lengths = []
    remaining_cap = dst_capacity - 6
    for k in range(4):
        seg = src[k * segment : (k + 1) * segment] if k < 3 else src[3 * segment :]
        c = huf_compress_1x_using_ctable(seg, ct, remaining_cap)
        if not c:
            return b""
        if k < 3 and len(c) > 65535:
            return b""
        lengths.append(len(c))
        out += c
        remaining_cap -= len(c)
    jump = b"".join(int(lengths[k]).to_bytes(2, "little") for k in range(3))
    return jump + bytes(out)


def huf_compress(
    src: bytes,
    max_symbol_value: int = HUF_SYMBOLVALUE_MAX,
    huff_log: int = HUF_TABLELOG_DEFAULT,
    four_streams: bool = True,
    old_table: HufCTable | None = None,
    repeat_mode: str | None = None,   # None | "check" | "valid"
    prefer_repeat: bool = False,
) -> BlockResult | tuple:
    """HUF_compress_internal (huf_compress.c:637-724).

    When `old_table` is given, returns (BlockResult, new_table, used_old).
    """
    src_size = len(src)
    dst_capacity = huf_compressbound(src_size)

    def _finish(table):
        payload = (
            huf_compress_4x_using_ctable(src, table, dst_capacity)
            if four_streams
            else huf_compress_1x_using_ctable(src, table, dst_capacity)
        )
        if not payload or len(payload) >= src_size - 1:
            return None
        return payload

    track_repeat = old_table is not None
    if src_size == 0 or src_size > 128 * 1024:
        r = BlockResult.raw()
        return (r, old_table, False) if track_repeat else r
    if not max_symbol_value:
        max_symbol_value = HUF_SYMBOLVALUE_MAX
    if not huff_log:
        huff_log = HUF_TABLELOG_DEFAULT

    if prefer_repeat and repeat_mode == "valid":
        payload = _finish(old_table)
        r = BlockResult.compressed(payload) if payload else BlockResult.raw()
        return (r, old_table, True) if track_repeat else r

    count, max_sv, largest = hist_count(src, max_symbol_value)
    if largest == src_size:
        r = BlockResult.rle()
        return (r, old_table, False) if track_repeat else r
    if largest <= (src_size >> 7) + 4:
        r = BlockResult.raw()
        return (r, old_table, False) if track_repeat else r

    if repeat_mode == "check" and old_table is not None and not huf_validate_ctable(old_table, count):
        repeat_mode = None
    if prefer_repeat and repeat_mode is not None and old_table is not None:
        payload = _finish(old_table)
        r = BlockResult.compressed(payload) if payload else BlockResult.raw()
        return (r, old_table, True) if track_repeat else r

    huff_log = fse_optimal_table_log(huff_log, src_size, max_sv, minus=1, max_allowed=HUF_TABLELOG_MAX)
    table = huf_build_ctable(count, max_sv, huff_log)
    header = huf_write_ctable(table, max_sv)

    if repeat_mode is not None and old_table is not None:
        old_size = huf_estimate_compressed_size(old_table, count)
        new_size = huf_estimate_compressed_size(table, count)
        if old_size <= len(header) + new_size or len(header) + 12 >= src_size:
            payload = _finish(old_table)
            r = BlockResult.compressed(payload) if payload else BlockResult.raw()
            return (r, old_table, True) if track_repeat else r

    if len(header) + 12 >= src_size:
        r = BlockResult.raw()
        return (r, old_table, False) if track_repeat else r

    payload = _finish(table)
    # the reference's final incompressibility check covers header + payload
    # (op-ostart >= srcSize-1, huf_compress.c:718-721)
    if payload is None or len(header) + len(payload) >= src_size - 1:
        r = BlockResult.raw()
        return (r, table, False) if track_repeat else r
    r = BlockResult.compressed(header + payload)
    return (r, table, False) if track_repeat else r


# ---------------------------------------------------------------------------
# Decode — X1 (single symbol per lookup)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DTableX1:
    table_log: int
    byte: np.ndarray     # uint8[2^tableLog]
    nb_bits: np.ndarray  # uint8[2^tableLog]


def huf_read_dtable_x1(src: bytes, max_table_log: int = HUF_TABLELOG_MAX):
    """huf_decompress.c:118-185. Returns (DTableX1, consumed)."""
    weights, rank_val, nb_symbols, table_log, used = huf_read_stats(src)
    if table_log > max_table_log + 1:
        raise FSEError(TABLELOG_TOO_LARGE)

    rank_val = rank_val.copy()
    next_rank = 0
    starts = np.zeros(HUF_TABLELOG_MAX + 1, dtype=np.int64)
    for n in range(1, table_log + 1):
        starts[n] = next_rank
        next_rank += int(rank_val[n]) << (n - 1)

    size = 1 << table_log
    byte = np.zeros(size, dtype=np.uint8)
    nb_bits = np.zeros(size, dtype=np.uint8)
    fill = starts.copy()
    for n in range(nb_symbols):
        w = weights[n]
        if w == 0:
            continue
        length = (1 << w) >> 1
        start = int(fill[w])
        byte[start : start + length] = n
        nb_bits[start : start + length] = table_log + 1 - w
        fill[w] += length
    return DTableX1(table_log, byte, nb_bits), used


class _HufStream:
    """One X1/X2 decode stream over a BitReader."""

    __slots__ = ("r",)

    def __init__(self, data: bytes):
        self.r = BitReader(data)


def _decode_stream_x1(reader: BitReader, out: bytearray, p: int, p_end: int, dt: DTableX1) -> int:
    """HUF_decodeStreamX1 (huf_decompress.c:214-237); returns new position."""
    dt_log = dt.table_log
    byte, nbb = dt.byte, dt.nb_bits

    def one():
        nonlocal p
        v = reader.look_bits_fast(dt_log)
        out[p] = int(byte[v])
        reader.skip_bits(int(nbb[v]))
        p += 1

    while reader.reload() == UNFINISHED and p < p_end - 3:
        one()
        one()
        one()
        one()
    while p < p_end:
        one()
    return p


def huf_decompress_1x1_using_dtable(csrc: bytes, dst_size: int, dt: DTableX1) -> bytes:
    out = bytearray(dst_size)
    reader = BitReader(csrc)
    _decode_stream_x1(reader, out, 0, dst_size, dt)
    if not reader.end_of_stream():
        raise CorruptionError("X1: stream not fully consumed")
    return bytes(out)


def _split_4streams(csrc: bytes):
    if len(csrc) < 10:
        raise CorruptionError("4X: input too small")
    l1 = int.from_bytes(csrc[0:2], "little")
    l2 = int.from_bytes(csrc[2:4], "little")
    l3 = int.from_bytes(csrc[4:6], "little")
    l4 = len(csrc) - (l1 + l2 + l3 + 6)
    if l4 < 0:
        raise CorruptionError("4X: jump table overflow")
    p = 6
    segs = []
    for ln in (l1, l2, l3, l4):
        segs.append(csrc[p : p + ln])
        p += ln
    return segs


def huf_decompress_4x1_using_dtable(csrc: bytes, dst_size: int, dt: DTableX1) -> bytes:
    """huf_decompress.c:263-353 — 4 streams in lock step."""
    segs = _split_4streams(csrc)
    readers = [BitReader(s) for s in segs]
    segment = (dst_size + 3) // 4
    out = bytearray(dst_size)
    pos = [0, segment, 2 * segment, 3 * segment]
    ends = [segment, 2 * segment, 3 * segment, dst_size]
    dt_log = dt.table_log
    byte, nbb = dt.byte, dt.nb_bits

    olimit = dst_size - 3
    end_signal = all(r.reload() == UNFINISHED for r in readers)
    while end_signal and pos[3] < olimit:
        for _ in range(4):
            for k in range(4):
                r = readers[k]
                v = r.look_bits_fast(dt_log)
                out[pos[k]] = int(byte[v])
                r.skip_bits(int(nbb[v]))
                pos[k] += 1
        for r in readers:
            ok = r.reload_fast() == UNFINISHED  # reload all 4 (side effects)
            end_signal = end_signal and ok

    if pos[0] > segment or pos[1] > 2 * segment or pos[2] > 3 * segment:
        raise CorruptionError("4X1: stream overrun")

    for k in range(4):
        pos[k] = _decode_stream_x1(readers[k], out, pos[k], ends[k], dt)
    if not all(r.end_of_stream() for r in readers):
        raise CorruptionError("4X1: streams not fully consumed")
    return bytes(out)


# ---------------------------------------------------------------------------
# Decode — X2 (up to two symbols per lookup)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DTableX2:
    table_log: int            # targetLog (maxTableLog)
    seq_lo: np.ndarray        # uint8 first byte
    seq_hi: np.ndarray        # uint8 second byte
    nb_bits: np.ndarray       # uint8
    length: np.ndarray        # uint8 (1 or 2)


def huf_read_dtable_x2(src: bytes, max_table_log: int = HUF_TABLELOG_MAX):
    """huf_decompress.c:551-649. Returns (DTableX2, consumed)."""
    weights, rank_stats, nb_symbols, table_log, used = huf_read_stats(src)
    if table_log > max_table_log:
        raise FSEError(TABLELOG_TOO_LARGE)

    max_w = table_log
    while rank_stats[max_w] == 0:
        max_w -= 1

    # start index of each weight in the sorted list
    rank_start = np.zeros(HUF_TABLELOG_MAX + 3, dtype=np.int64)  # rankStart0[w]; +1 shift
    next_start = 0
    for w in range(1, max_w + 1):
        rank_start[w + 1] = next_start
        next_start += int(rank_stats[w])
    rank_start[0 + 1] = next_start  # 0-weight symbols at the end
    size_of_sort = next_start

    sorted_sym = np.zeros(nb_symbols, dtype=np.int64)
    sorted_wgt = np.zeros(nb_symbols, dtype=np.int64)
    fill = rank_start.copy()
    for s in range(nb_symbols):
        w = weights[s]
        r = int(fill[w + 1])
        fill[w + 1] += 1
        sorted_sym[r] = s
        sorted_wgt[r] = w
    rank_start[0 + 1] = 0  # forget 0-weight symbols

    # rankVal: per consumed-bits base offsets
    rank_val = np.zeros((HUF_TABLELOG_MAX, HUF_TABLELOG_MAX + 1), dtype=np.int64)
    rescale = (max_table_log - table_log) - 1
    next_val = 0
    for w in range(1, max_w + 1):
        rank_val[0][w] = next_val
        next_val += int(rank_stats[w]) << (w + rescale)
    min_bits = table_log + 1 - max_w
    for consumed in range(min_bits, max_table_log - min_bits + 1):
        for w in range(1, max_w + 1):
            rank_val[consumed][w] = rank_val[0][w] >> consumed

    size = 1 << max_table_log
    seq_lo = np.zeros(size, dtype=np.uint8)
    seq_hi = np.zeros(size, dtype=np.uint8)
    nb_bits = np.zeros(size, dtype=np.uint8)
    length = np.ones(size, dtype=np.uint8)
    nb_bits_baseline = table_log + 1
    scale_log = nb_bits_baseline - max_table_log  # <= 1

    def fill_level2(base, size_log, consumed, rank_val_origin, min_weight, sorted_from, base_seq):
        rv = rank_val_origin.copy()
        if min_weight > 1:
            skip = int(rv[min_weight])
            seq_lo[base : base + skip] = base_seq & 0xFF
            seq_hi[base : base + skip] = (base_seq >> 8) & 0xFF
            nb_bits[base : base + skip] = consumed
            length[base : base + skip] = 1
        for idx in range(sorted_from, size_of_sort):
            sym = int(sorted_sym[idx])
            wgt = int(sorted_wgt[idx])
            nbits = nb_bits_baseline - wgt
            ln = 1 << (size_log - nbits)
            start = base + int(rv[wgt])
            seq = (base_seq + (sym << 8)) & 0xFFFF
            seq_lo[start : start + ln] = seq & 0xFF
            seq_hi[start : start + ln] = seq >> 8
            nb_bits[start : start + ln] = nbits + consumed
            length[start : start + ln] = 2
            rv[wgt] += ln

    rv_top = rank_val[0].copy()
    for idx in range(size_of_sort):
        sym = int(sorted_sym[idx])
        wgt = int(sorted_wgt[idx])
        nbits = nb_bits_baseline - wgt
        start = int(rv_top[wgt])
        ln = 1 << (max_table_log - nbits)
        if max_table_log - nbits >= min_bits:
            # enough room for a second symbol
            min_weight = nbits + scale_log
            if min_weight < 1:
                min_weight = 1
            fill_level2(
                start,
                max_table_log - nbits,
                nbits,
                rank_val[nbits],
                min_weight,
                int(rank_start[min_weight + 1]),
                sym,
            )
        else:
            seq_lo[start : start + ln] = sym & 0xFF
            seq_hi[start : start + ln] = 0
            nb_bits[start : start + ln] = nbits
            length[start : start + ln] = 1
        rv_top[wgt] += ln

    return DTableX2(max_table_log, seq_lo, seq_hi, nb_bits, length), used


def _decode_stream_x2(reader: BitReader, out: bytearray, p: int, p_end: int, dt: DTableX2) -> int:
    """HUF_decodeStreamX2 (huf_decompress.c:696-720)."""
    dt_log = dt.table_log

    def one():
        nonlocal p
        v = reader.look_bits_fast(dt_log)
        out[p] = int(dt.seq_lo[v])
        if dt.length[v] == 2:
            out[p + 1] = int(dt.seq_hi[v])
        reader.skip_bits(int(dt.nb_bits[v]))
        p += int(dt.length[v])

    while reader.reload() == UNFINISHED and p < p_end - 7:
        one()
        one()
        one()
        one()
    while reader.reload() == UNFINISHED and p <= p_end - 2:
        one()
    while p <= p_end - 2:
        one()
    if p < p_end:
        # decodeLastSymbolX2: write 1 byte; careful bit accounting
        v = reader.look_bits_fast(dt_log)
        out[p] = int(dt.seq_lo[v])
        if dt.length[v] == 1:
            reader.skip_bits(int(dt.nb_bits[v]))
        else:
            if reader.bits_consumed < 64:
                reader.skip_bits(int(dt.nb_bits[v]))
                if reader.bits_consumed > 64:
                    reader.bits_consumed = 64
        p += 1
    return p


def huf_decompress_1x2_using_dtable(csrc: bytes, dst_size: int, dt: DTableX2) -> bytes:
    out = bytearray(dst_size + 1)  # slack byte for the 2-byte writes
    reader = BitReader(csrc)
    _decode_stream_x2(reader, out, 0, dst_size, dt)
    if not reader.end_of_stream():
        raise CorruptionError("X2: stream not fully consumed")
    return bytes(out[:dst_size])


def huf_decompress_4x2_using_dtable(csrc: bytes, dst_size: int, dt: DTableX2) -> bytes:
    segs = _split_4streams(csrc)
    readers = [BitReader(s) for s in segs]
    segment = (dst_size + 3) // 4
    out = bytearray(dst_size + 8)
    pos = [0, segment, 2 * segment, 3 * segment]
    ends = [segment, 2 * segment, 3 * segment, dst_size]
    dt_log = dt.table_log

    olimit = dst_size - 7
    end_signal = all(r.reload() == UNFINISHED for r in readers)
    while end_signal and pos[3] < olimit:
        for _ in range(4):
            for k in range(4):
                r = readers[k]
                v = r.look_bits_fast(dt_log)
                out[pos[k]] = int(dt.seq_lo[v])
                if dt.length[v] == 2:
                    out[pos[k] + 1] = int(dt.seq_hi[v])
                r.skip_bits(int(dt.nb_bits[v]))
                pos[k] += int(dt.length[v])
        for r in readers:
            ok = r.reload_fast() == UNFINISHED  # reload all 4 (side effects)
            end_signal = end_signal and ok

    if pos[0] > segment or pos[1] > 2 * segment or pos[2] > 3 * segment:
        raise CorruptionError("4X2: stream overrun")

    for k in range(4):
        _decode_stream_x2(readers[k], out, pos[k], ends[k], dt)
    if not all(r.end_of_stream() for r in readers):
        raise CorruptionError("4X2: streams not fully consumed")
    return bytes(out[:dst_size])


# ---------------------------------------------------------------------------
# Selector and one-shot decompress
# ---------------------------------------------------------------------------

# empirical decode-time table (huf_decompress.c:1002-1021)
_ALGO_TIME = (
    ((0, 0), (1, 1)),
    ((0, 0), (1, 1)),
    ((38, 130), (1313, 74)),
    ((448, 128), (1353, 74)),
    ((556, 128), (1353, 74)),
    ((714, 128), (1418, 74)),
    ((883, 128), (1437, 74)),
    ((897, 128), (1515, 75)),
    ((926, 128), (1613, 75)),
    ((947, 128), (1729, 77)),
    ((1107, 128), (2083, 81)),
    ((1177, 128), (2379, 87)),
    ((1242, 128), (2415, 93)),
    ((1349, 128), (2644, 106)),
    ((1455, 128), (2422, 124)),
    ((722, 128), (1891, 145)),
)


def huf_select_decoder(dst_size: int, c_src_size: int) -> int:
    """0 -> 4X1, 1 -> 4X2 (huf_decompress.c:1029-1051)."""
    q = 15 if c_src_size >= dst_size else (c_src_size * 16) // dst_size
    d256 = dst_size >> 8
    dtime0 = _ALGO_TIME[q][0][0] + _ALGO_TIME[q][0][1] * d256
    dtime1 = _ALGO_TIME[q][1][0] + _ALGO_TIME[q][1][1] * d256
    dtime1 += dtime1 >> 3  # X2 memory penalty
    return 1 if dtime1 < dtime0 else 0


def huf_decompress_4x1(csrc: bytes, dst_size: int) -> bytes:
    dt, used = huf_read_dtable_x1(csrc)
    if used >= len(csrc):
        raise FSEError(SRC_SIZE_WRONG)
    return huf_decompress_4x1_using_dtable(csrc[used:], dst_size, dt)


def huf_decompress_4x2(csrc: bytes, dst_size: int) -> bytes:
    dt, used = huf_read_dtable_x2(csrc)
    if used >= len(csrc):
        raise FSEError(SRC_SIZE_WRONG)
    return huf_decompress_4x2_using_dtable(csrc[used:], dst_size, dt)


def huf_decompress_1x1(csrc: bytes, dst_size: int) -> bytes:
    dt, used = huf_read_dtable_x1(csrc)
    if used >= len(csrc):
        raise FSEError(SRC_SIZE_WRONG)
    return huf_decompress_1x1_using_dtable(csrc[used:], dst_size, dt)


def huf_decompress_1x2(csrc: bytes, dst_size: int) -> bytes:
    dt, used = huf_read_dtable_x2(csrc)
    if used >= len(csrc):
        raise FSEError(SRC_SIZE_WRONG)
    return huf_decompress_1x2_using_dtable(csrc[used:], dst_size, dt)


def huf_decompress(csrc: bytes, dst_size: int) -> bytes:
    """HUF_decompress (huf_decompress.c:1056-1081) incl. raw/RLE shortcuts."""
    if dst_size == 0:
        raise FSEError(GENERIC, "dstSize == 0")
    if len(csrc) > dst_size:
        raise CorruptionError("cSrc larger than regenerated size")
    if len(csrc) == dst_size:
        return bytes(csrc)
    if len(csrc) == 1:
        return bytes([csrc[0]]) * dst_size
    if huf_select_decoder(dst_size, len(csrc)):
        return huf_decompress_4x2(csrc, dst_size)
    return huf_decompress_4x1(csrc, dst_size)
