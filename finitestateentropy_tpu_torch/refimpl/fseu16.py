"""FSE for 16-bit symbols (alphabets > 256) — twin of reference lib/fseU16.c.

Differences from the byte codec: tableLog max 13 / default 12 (fseU16.c:43-48),
default maxSymbolValue 286 / absolute max 4095 (fseU16.h:50, fseU16.c:54),
a single coder state (fseU16.c:150-200), and a decoder that drains residual
symbols out of the final state after the bitstream ends (fseU16.c:288-298).
"""
from __future__ import annotations

import numpy as np

from ..config import (
    FSEU16_DEFAULT_TABLELOG,
    FSEU16_MAX_SYMBOL_VALUE,
    FSEU16_MAX_TABLELOG,
    FSEU16_SYMBOLVALUE_ABSOLUTEMAX,
    fse_compressbound,
)
from ..errors import (
    CorruptionError,
    FSEError,
    MAX_SYMBOL_VALUE_TOO_LARGE,
    MAX_SYMBOL_VALUE_TOO_SMALL,
    SRC_SIZE_WRONG,
    TABLELOG_TOO_LARGE,
)
from .bitstream import BitReader, BitWriter, COMPLETED
from .blocktypes import BlockResult
from .ncount import fse_read_ncount, fse_write_ncount
from .norm import fse_normalize_count, fse_optimal_table_log
from .tables import CTable, DTable, build_ctable, build_dtable


def count_u16(src: np.ndarray, max_symbol_value: int):
    """FSE_countU16 (fseU16.c:121-145): errors on out-of-range symbols."""
    arr = np.asarray(src, dtype=np.uint16)
    if arr.size == 0:
        return np.zeros(1, dtype=np.uint32), 0, 0
    if int(arr.max()) > max_symbol_value:
        raise FSEError(MAX_SYMBOL_VALUE_TOO_SMALL)
    counts = np.bincount(arr, minlength=max_symbol_value + 1).astype(np.uint32)
    true_max = int(arr.max())
    return counts[: true_max + 1], true_max, int(counts.max())


def fse_compress_u16_using_ctable(src: np.ndarray, ct: CTable, dst_capacity: int) -> bytes:
    """Single-state backward encode (fseU16.c:150-200)."""
    src_size = len(src)
    w = BitWriter(dst_capacity)
    state = 1 << ct.table_log  # FSE_initCState
    st, dfs, dnb = ct.state_table, ct.delta_find_state, ct.delta_nb_bits

    def enc(sym: int):
        nonlocal state
        nb = (state + int(dnb[sym])) >> 16
        w.add_bits(state, nb)
        state = int(st[(state >> nb) + int(dfs[sym])])

    ip = src_size
    if src_size & 1:
        enc(int(src[ip - 1]))
        w.flush()
        ip -= 1
    if src_size & 2:
        enc(int(src[ip - 1]))
        enc(int(src[ip - 2]))
        w.flush()
        ip -= 2
    while ip > 0:
        enc(int(src[ip - 1]))
        enc(int(src[ip - 2]))
        enc(int(src[ip - 3]))
        enc(int(src[ip - 4]))
        w.flush()
        ip -= 4

    w.add_bits(state, ct.table_log)  # FSE_flushCState
    w.flush()
    size = w.close()
    return w.bytes(size) if size else b""


def fse_compress_u16(
    src,
    max_symbol_value: int = 0,
    table_log: int = 0,
) -> BlockResult:
    """FSE_compressU16 (fseU16.c:203-251)."""
    arr = np.asarray(src, dtype=np.uint16)
    src_size = arr.size
    if src_size <= 1:
        return BlockResult.raw()
    if not max_symbol_value:
        max_symbol_value = FSEU16_MAX_SYMBOL_VALUE
    if not table_log:
        table_log = FSEU16_DEFAULT_TABLELOG
    if max_symbol_value > FSEU16_SYMBOLVALUE_ABSOLUTEMAX:
        raise FSEError(MAX_SYMBOL_VALUE_TOO_LARGE)
    if table_log > FSEU16_MAX_TABLELOG:
        raise FSEError(TABLELOG_TOO_LARGE)

    count, max_sv, max_count = count_u16(arr, max_symbol_value)
    if max_count == src_size:
        return BlockResult.rle()

    table_log = fse_optimal_table_log(
        table_log, src_size, max_sv, default_table_log=FSEU16_DEFAULT_TABLELOG,
        max_allowed=FSEU16_MAX_TABLELOG,
    )
    norm, table_log = fse_normalize_count(
        table_log, count, src_size, max_sv, max_table_log=FSEU16_MAX_TABLELOG
    )
    if norm is None:
        return BlockResult.rle()
    header = fse_write_ncount(norm, max_sv, table_log)
    ct = build_ctable(norm, max_sv, table_log)
    payload = fse_compress_u16_using_ctable(arr, ct, fse_compressbound(src_size * 2))
    out = header + payload
    if len(out) >= (src_size - 1) * 2:
        return BlockResult.raw()
    return BlockResult.compressed(out)


def fse_decompress_u16_using_dtable(csrc: bytes, dt: DTable, max_dst_size: int) -> np.ndarray:
    """fseU16.c:273-301 — single state + post-stream state drain."""
    reader = BitReader(csrc)
    state = reader.read_bits(dt.table_log)
    reader.reload()
    new_state, symbols, nb_bits = dt.new_state, dt.symbol, dt.nb_bits
    out = np.zeros(max_dst_size, dtype=np.uint16)
    n = 0

    while reader.reload() < COMPLETED and n < max_dst_size:
        out[n] = symbols[state]
        state = int(new_state[state]) + reader.read_bits(int(nb_bits[state]))
        n += 1

    if not reader.end_of_stream():
        raise CorruptionError("u16: stream not fully consumed")

    while state != 0 and n < max_dst_size:
        out[n] = symbols[state]
        state = int(new_state[state]) + reader.read_bits(int(nb_bits[state]))
        n += 1

    if state != 0:
        raise CorruptionError("u16: residual state")
    return out[:n]


def fse_decompress_u16(csrc: bytes, max_dst_size: int,
                       max_symbol_value: int = FSEU16_MAX_SYMBOL_VALUE) -> np.ndarray:
    """FSE_decompressU16 (fseU16.c:306-329).

    max_symbol_value mirrors the FSEU16_MAX_SYMBOL_VALUE compile knob
    (fseU16.h:49-55): the reference default build accepts <= 286; rebuilds
    with a larger knob accept up to the absolute max 4095 (fseU16.c:54)."""
    if len(csrc) < 2:
        raise FSEError(SRC_SIZE_WRONG)
    norm, max_sv, table_log, used = fse_read_ncount(csrc, max_symbol_value)
    if table_log > FSEU16_MAX_TABLELOG:
        raise FSEError(TABLELOG_TOO_LARGE)
    dt = build_dtable(norm, max_sv, table_log)
    return fse_decompress_u16_using_dtable(csrc[used:], dt, max_dst_size)
