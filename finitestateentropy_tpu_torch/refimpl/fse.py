"""FSE (tANS) block codec — host-exact twin.

Encoder: backward traversal with two interleaved coder states and the exact
flush cadence of the reference (fse_compress.c:554-623); decoder mirrors
fse_decompress.c:178-287.  Byte-for-byte identical output is a hard
requirement (tests compare against the reference CLI).
"""
from __future__ import annotations

import numpy as np

from ..config import (
    FSE_DEFAULT_TABLELOG,
    FSE_MAX_SYMBOL_VALUE,
    FSE_MAX_TABLELOG,
    fse_compressbound,
)
from ..errors import CorruptionError, FSEError, DST_SIZE_TOO_SMALL, TABLELOG_TOO_LARGE
from .bitstream import (
    BitReader,
    BitWriter,
    COMPLETED,
    END_OF_BUFFER,
    OVERFLOW,
    UNFINISHED,
)
from .blocktypes import BlockResult
from .hist import hist_count
from .ncount import fse_read_ncount, fse_write_ncount
from .norm import fse_normalize_count, fse_optimal_table_log
from .tables import CTable, DTable, build_ctable, build_dtable


class _CState:
    """One tANS coder state (lib/fse.h:488-527)."""

    __slots__ = ("value", "ct")

    def __init__(self, ct: CTable, first_symbol: int | None = None):
        self.ct = ct
        self.value = 1 << ct.table_log
        if first_symbol is not None:
            # FSE_initCState2: seed at the cheapest state for the first
            # (i.e. last-decoded) symbol, saving its bit cost.
            dnb = int(ct.delta_nb_bits[first_symbol])
            nb_bits_out = (dnb + (1 << 15)) >> 16
            value = (nb_bits_out << 16) - dnb
            self.value = int(ct.state_table[(value >> nb_bits_out) + int(ct.delta_find_state[first_symbol])])

    def encode(self, writer: BitWriter, symbol: int) -> None:
        ct = self.ct
        nb_bits_out = (self.value + int(ct.delta_nb_bits[symbol])) >> 16
        writer.add_bits(self.value, nb_bits_out)
        self.value = int(ct.state_table[(self.value >> nb_bits_out) + int(ct.delta_find_state[symbol])])

    def flush(self, writer: BitWriter) -> None:
        writer.add_bits(self.value, self.ct.table_log)
        writer.flush()


def fse_compress_using_ctable(src: bytes, ct: CTable, dst_capacity: int | None = None,
                              max_table_log: int = FSE_MAX_TABLELOG) -> bytes:
    """2-state interleaved backward encode.  Returns b"" if not storable."""
    src_size = len(src)
    if src_size <= 2:
        return b""
    if dst_capacity is None:
        dst_capacity = fse_compressbound(src_size)
    try:
        w = BitWriter(dst_capacity)
    except ValueError:
        return b""
    ip = src_size

    # 64-bit register: the reference's static width tests resolve to
    # "prologue for odd srcSize, optional pair, then 4 symbols per flush".
    if src_size & 1:
        c1 = _CState(ct, src[ip - 1])
        c2 = _CState(ct, src[ip - 2])
        c1.encode(w, src[ip - 3])
        w.flush()
        ip -= 3
    else:
        c2 = _CState(ct, src[ip - 1])
        c1 = _CState(ct, src[ip - 2])
        ip -= 2

    if (src_size - 2) & 2 and 64 > max_table_log * 4 + 7:
        c2.encode(w, src[ip - 1])
        c1.encode(w, src[ip - 2])
        w.flush()
        ip -= 2

    while ip > 0:
        c2.encode(w, src[ip - 1])
        c1.encode(w, src[ip - 2])
        c2.encode(w, src[ip - 3])
        c1.encode(w, src[ip - 4])
        w.flush()
        ip -= 4

    c2.flush(w)
    c1.flush(w)
    size = w.close()
    return w.bytes(size) if size else b""


def fse_decompress_using_dtable(csrc: bytes, dt: DTable, max_dst_size: int) -> bytes:
    """2-state interleaved decode (fse_decompress.c:178-238)."""
    reader = BitReader(csrc)
    table_log = dt.table_log
    new_state, symbols, nb_bits = dt.new_state, dt.symbol, dt.nb_bits

    # FSE_initDState x2 (flush order reversed by writer)
    s1 = reader.read_bits(table_log)
    reader.reload()
    s2 = reader.read_bits(table_log)
    reader.reload()

    out = bytearray()

    def decode(state: int) -> tuple[int, int]:
        bits = int(nb_bits[state])
        sym = int(symbols[state])
        low = reader.read_bits(bits)
        return int(new_state[state]) + low, sym

    olimit = max_dst_size - 3
    # 4 symbols per reload while the window is full
    while reader.reload() == UNFINISHED and len(out) < olimit:
        s1, sym = decode(s1)
        out.append(sym)
        s2, sym = decode(s2)
        out.append(sym)
        s1, sym = decode(s1)
        out.append(sym)
        s2, sym = decode(s2)
        out.append(sym)

    # tail: alternate until the stream signals overflow
    while True:
        if len(out) > max_dst_size - 2:
            raise FSEError(DST_SIZE_TOO_SMALL)
        s1, sym = decode(s1)
        out.append(sym)
        if reader.reload() == OVERFLOW:
            s2, sym = decode(s2)
            out.append(sym)
            break
        if len(out) > max_dst_size - 2:
            raise FSEError(DST_SIZE_TOO_SMALL)
        s2, sym = decode(s2)
        out.append(sym)
        if reader.reload() == OVERFLOW:
            s1, sym = decode(s1)
            out.append(sym)
            break
    return bytes(out)


def fse_compress(
    src: bytes,
    max_symbol_value: int = FSE_MAX_SYMBOL_VALUE,
    table_log: int = FSE_DEFAULT_TABLELOG,
) -> BlockResult:
    """Full pipeline: count → normalize → writeNCount → buildCTable → encode.

    Mirrors FSE_compress_wksp (fse_compress.c:632-677) including the
    RLE / not-compressible heuristics and final compressibility check.
    """
    src_size = len(src)
    if src_size <= 1:
        return BlockResult.raw()
    if not max_symbol_value:
        max_symbol_value = FSE_MAX_SYMBOL_VALUE
    if not table_log:
        table_log = FSE_DEFAULT_TABLELOG
    if table_log > FSE_MAX_TABLELOG:
        raise FSEError(TABLELOG_TOO_LARGE)

    count, max_sv, max_count = hist_count(src, max_symbol_value)
    if max_count == src_size:
        return BlockResult.rle()
    if max_count == 1:
        return BlockResult.raw()
    if max_count < (src_size >> 7):
        return BlockResult.raw()

    table_log = fse_optimal_table_log(table_log, src_size, max_sv)
    norm, table_log = fse_normalize_count(table_log, count, src_size, max_sv)
    if norm is None:
        return BlockResult.rle()

    header = fse_write_ncount(norm, max_sv, table_log)
    ct = build_ctable(norm, max_sv, table_log)
    payload = fse_compress_using_ctable(src, ct)
    if not payload:
        return BlockResult.raw()
    if len(header) + len(payload) >= src_size - 1:
        return BlockResult.raw()
    return BlockResult.compressed(header + payload)


def fse_decompress(csrc: bytes, dst_capacity: int) -> bytes:
    """readNCount → buildDTable → decode (fse_decompress.c:255-283)."""
    norm, max_sv, table_log, used = fse_read_ncount(csrc)
    if table_log > FSE_MAX_TABLELOG:
        raise FSEError(TABLELOG_TOO_LARGE)
    dt = build_dtable(norm, max_sv, table_log)
    return fse_decompress_using_dtable(csrc[used:], dt, dst_capacity)
