"""FSE table construction (reference fse_compress.c:66-176, fse_decompress.c:71-126).

The symbol spread order — stepping ``pos = (pos + step) & mask`` skipping the
low-probability region — is a frozen wire-format contract: encoder and decoder
tables must place symbols in exactly this order.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..config import fse_tablestep
from ..errors import FSEError, GENERIC
from .bitstream import highbit32


def spread_symbols(norm, max_symbol_value: int, table_log: int) -> np.ndarray:
    """Return tableSymbol[tableSize]: which symbol occupies each state cell.

    Low-probability (-1) symbols occupy the topmost cells; positive counts are
    scattered with the (5/8)size+3 step (fse_compress.c:96-122).
    """
    table_size = 1 << table_log
    table_mask = table_size - 1
    step = fse_tablestep(table_size)
    table = np.zeros(table_size, dtype=np.int32)
    high_threshold = table_size - 1

    for s in range(max_symbol_value + 1):
        if norm[s] == -1:
            table[high_threshold] = s
            high_threshold -= 1

    position = 0
    for s in range(max_symbol_value + 1):
        freq = norm[s]
        for _ in range(max(freq, 0)):
            table[position] = s
            position = (position + step) & table_mask
            while position > high_threshold:
                position = (position + step) & table_mask
    if position != 0:
        raise FSEError(GENERIC, "spread did not cover table")
    return table


@dataclasses.dataclass
class CTable:
    """Encoder table.

    state_table[tableSize]: next-state values ordered by (symbol, occurrence);
    delta_find_state[s], delta_nb_bits[s]: the per-symbol transform
    (fse_compress.c:130-154, struct lib/fse.h:483-486).
    """

    table_log: int
    max_symbol_value: int
    state_table: np.ndarray      # uint16[tableSize]
    delta_find_state: np.ndarray  # int32[maxSV+1]
    delta_nb_bits: np.ndarray     # uint32[maxSV+1]


def build_ctable(norm, max_symbol_value: int, table_log: int) -> CTable:
    table_size = 1 << table_log
    table_symbol = spread_symbols(norm, max_symbol_value, table_log)

    # cumulative start per symbol; low-prob symbols get one slot
    cumul = np.zeros(max_symbol_value + 2, dtype=np.int64)
    for s in range(max_symbol_value + 1):
        cumul[s + 1] = cumul[s] + (1 if norm[s] == -1 else norm[s])
    cumul[max_symbol_value + 1] = table_size + 1

    state_table = np.zeros(table_size, dtype=np.uint16)
    cpos = cumul.copy()
    for u in range(table_size):
        s = int(table_symbol[u])
        state_table[cpos[s]] = table_size + u  # next state value
        cpos[s] += 1

    delta_find_state = np.zeros(max_symbol_value + 1, dtype=np.int64)
    delta_nb_bits = np.zeros(max_symbol_value + 1, dtype=np.int64)
    total = 0
    for s in range(max_symbol_value + 1):
        n = norm[s]
        if n == 0:
            delta_nb_bits[s] = ((table_log + 1) << 16) - table_size
        elif n in (-1, 1):
            delta_nb_bits[s] = (table_log << 16) - table_size
            delta_find_state[s] = total - 1
            total += 1
        else:
            max_bits_out = table_log - highbit32(n - 1)
            min_state_plus = n << max_bits_out
            delta_nb_bits[s] = (max_bits_out << 16) - min_state_plus
            delta_find_state[s] = total - n
            total += n
    return CTable(table_log, max_symbol_value, state_table, delta_find_state, delta_nb_bits)


def build_ctable_rle(symbol: int) -> CTable:
    """fse_compress.c:531-551 — degenerate table encoding a constant symbol."""
    state_table = np.zeros(2, dtype=np.uint16)
    dfs = np.zeros(symbol + 1, dtype=np.int64)
    dnb = np.zeros(symbol + 1, dtype=np.int64)
    return CTable(0, symbol, state_table, dfs, dnb)


def build_ctable_raw(nb_bits: int) -> CTable:
    """fse_compress.c:498-528 — flat nbBits for every symbol."""
    table_size = 1 << nb_bits
    state_table = (np.arange(table_size, dtype=np.uint32) + table_size).astype(np.uint16)
    max_sv = table_size - 1
    dnb = np.full(max_sv + 1, (nb_bits << 16) - table_size, dtype=np.int64)
    dfs = np.arange(max_sv + 1, dtype=np.int64) - 1
    return CTable(nb_bits, max_sv, state_table, dfs, dnb)


@dataclasses.dataclass
class DTable:
    """Decoder table: per state {new_state, symbol, nb_bits} plus fastMode."""

    table_log: int
    fast_mode: bool
    new_state: np.ndarray  # uint16[tableSize]
    symbol: np.ndarray     # uint16[tableSize] (uint8 range for byte alphabet)
    nb_bits: np.ndarray    # uint8[tableSize]


def build_dtable(norm, max_symbol_value: int, table_log: int) -> DTable:
    """fse_decompress.c:71-126."""
    table_size = 1 << table_log
    symbols = np.zeros(table_size, dtype=np.int32)
    symbol_next = np.zeros(max_symbol_value + 1, dtype=np.int64)
    high_threshold = table_size - 1
    fast_mode = True
    large_limit = 1 << (table_log - 1)

    for s in range(max_symbol_value + 1):
        if norm[s] == -1:
            symbols[high_threshold] = s
            high_threshold -= 1
            symbol_next[s] = 1
        else:
            if norm[s] >= large_limit:
                fast_mode = False
            symbol_next[s] = norm[s]

    # spread (positive counts only; low-prob already placed)
    table_mask = table_size - 1
    step = fse_tablestep(table_size)
    position = 0
    for s in range(max_symbol_value + 1):
        for _ in range(max(norm[s], 0)):
            symbols[position] = s
            position = (position + step) & table_mask
            while position > high_threshold:
                position = (position + step) & table_mask
    if position != 0:
        raise FSEError(GENERIC, "dtable spread did not cover table")

    new_state = np.zeros(table_size, dtype=np.uint16)
    nb_bits = np.zeros(table_size, dtype=np.uint8)
    nxt = symbol_next.copy()
    for u in range(table_size):
        s = int(symbols[u])
        next_state = int(nxt[s])
        nxt[s] += 1
        bits = table_log - highbit32(next_state)
        nb_bits[u] = bits
        new_state[u] = (next_state << bits) - table_size
    return DTable(table_log, fast_mode, new_state, symbols.astype(np.uint16), nb_bits)


def build_dtable_rle(symbol: int) -> DTable:
    return DTable(
        0,
        False,
        np.zeros(1, dtype=np.uint16),
        np.array([symbol], dtype=np.uint16),
        np.zeros(1, dtype=np.uint8),
    )


def build_dtable_raw(nb_bits: int) -> DTable:
    size = 1 << nb_bits
    return DTable(
        nb_bits,
        True,
        np.zeros(size, dtype=np.uint16),
        np.arange(size, dtype=np.uint16),
        np.full(size, nb_bits, dtype=np.uint8),
    )
