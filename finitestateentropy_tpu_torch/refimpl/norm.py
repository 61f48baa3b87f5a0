"""Count normalization to a power-of-two total (reference fse_compress.c:316-494).

This must be *bit-identical* to the reference: the normalized counts drive the
table spread, hence the entire wire format.  All arithmetic is done with
Python ints mirroring the C U64/U32 widths.
"""
from __future__ import annotations

from ..config import (
    FSE_DEFAULT_TABLELOG,
    FSE_MIN_TABLELOG,
)
from ..errors import FSEError, GENERIC, TABLELOG_TOO_LARGE
from .bitstream import highbit32

# rounding thresholds, fse_compress.c:445
_RTB_TABLE = (0, 473195, 504333, 520860, 550000, 700000, 750000, 830000)


def fse_min_table_log(src_size: int, max_symbol_value: int) -> int:
    """fse_compress.c:316-323."""
    min_bits_src = highbit32(src_size) + 1
    min_bits_symbols = highbit32(max_symbol_value) + 2
    return min(min_bits_src, min_bits_symbols)


def fse_optimal_table_log(
    max_table_log: int,
    src_size: int,
    max_symbol_value: int,
    minus: int = 2,
    *,
    default_table_log: int = FSE_DEFAULT_TABLELOG,
    max_allowed: int = None,
) -> int:
    """fse_compress.c:325-342 (minus=2 for FSE, 1 for HUF)."""
    from ..config import FSE_MAX_TABLELOG

    if max_allowed is None:
        max_allowed = FSE_MAX_TABLELOG
    max_bits_src = highbit32(src_size - 1) - minus
    table_log = max_table_log if max_table_log else default_table_log
    min_bits = fse_min_table_log(src_size, max_symbol_value)
    if max_bits_src < table_log:
        table_log = max_bits_src
    if min_bits > table_log:
        table_log = min_bits
    table_log = max(table_log, FSE_MIN_TABLELOG)
    table_log = min(table_log, max_allowed)
    return table_log


def _normalize_m2(norm, table_log, count, total, max_symbol_value):
    """Fallback distribution by fractional steps (fse_compress.c:348-432)."""
    NOT_YET = -2
    distributed = 0
    low_threshold = total >> table_log
    low_one = (total * 3) >> (table_log + 1)

    for s in range(max_symbol_value + 1):
        c = int(count[s])
        if c == 0:
            norm[s] = 0
            continue
        if c <= low_threshold:
            norm[s] = -1
            distributed += 1
            total -= c
            continue
        if c <= low_one:
            norm[s] = 1
            distributed += 1
            total -= c
            continue
        norm[s] = NOT_YET
    to_distribute = (1 << table_log) - distributed
    if to_distribute == 0:
        return

    if to_distribute and (total // to_distribute) > low_one:
        # risk of rounding to zero: widen the "1" bucket
        low_one = (total * 3) // (to_distribute * 2)
        for s in range(max_symbol_value + 1):
            if norm[s] == NOT_YET and int(count[s]) <= low_one:
                norm[s] = 1
                distributed += 1
                total -= int(count[s])
        to_distribute = (1 << table_log) - distributed

    if distributed == max_symbol_value + 1:
        # all symbols low: dump everything on the most frequent
        max_v, max_c = 0, 0
        for s in range(max_symbol_value + 1):
            if int(count[s]) > max_c:
                max_v, max_c = s, int(count[s])
        norm[max_v] += to_distribute
        return

    if total == 0:
        # round-robin +1 over already-positive symbols
        s = 0
        while to_distribute > 0:
            if norm[s] > 0:
                to_distribute -= 1
                norm[s] += 1
            s = (s + 1) % (max_symbol_value + 1)
        return

    v_step_log = 62 - table_log
    mid = (1 << (v_step_log - 1)) - 1
    r_step = (((1 << v_step_log) * to_distribute) + mid) // total
    tmp_total = mid
    for s in range(max_symbol_value + 1):
        if norm[s] == NOT_YET:
            end = tmp_total + int(count[s]) * r_step
            s_start = tmp_total >> v_step_log
            s_end = end >> v_step_log
            weight = s_end - s_start
            if weight < 1:
                raise FSEError(GENERIC, "normalizeM2 underflow")
            norm[s] = weight
            tmp_total = end


def fse_normalize_count(
    table_log: int,
    count,
    total: int,
    max_symbol_value: int,
    *,
    max_table_log: int = None,
):
    """Return (norm list[int], table_log). Mirrors fse_compress.c:435-494.

    A norm entry of -1 marks a low-probability symbol that is given one state
    slot in the high region of the table.
    """
    from ..config import FSE_MAX_TABLELOG

    if max_table_log is None:
        max_table_log = FSE_MAX_TABLELOG
    if table_log == 0:
        table_log = FSE_DEFAULT_TABLELOG
    if table_log < FSE_MIN_TABLELOG:
        raise FSEError(GENERIC, "tableLog too small")
    if table_log > max_table_log:
        raise FSEError(TABLELOG_TOO_LARGE)
    if table_log < fse_min_table_log(total, max_symbol_value):
        raise FSEError(GENERIC, "tableLog too small for distribution")

    norm = [0] * (max_symbol_value + 1)
    scale = 62 - table_log
    step = (1 << 62) // total
    v_step = 1 << (scale - 20)
    still_to_distribute = 1 << table_log
    largest = 0
    largest_p = 0
    low_threshold = total >> table_log

    for s in range(max_symbol_value + 1):
        c = int(count[s])
        if c == total:
            return None, table_log  # RLE special case (caller handles)
        if c == 0:
            norm[s] = 0
            continue
        if c <= low_threshold:
            norm[s] = -1
            still_to_distribute -= 1
        else:
            proba = (c * step) >> scale
            if proba < 8:
                rest_to_beat = v_step * _RTB_TABLE[proba]
                if (c * step) - (proba << scale) > rest_to_beat:
                    proba += 1
            if proba > largest_p:
                largest_p = proba
                largest = s
            norm[s] = proba
            still_to_distribute -= proba

    if -still_to_distribute >= (norm[largest] >> 1):
        _normalize_m2(norm, table_log, count, total, max_symbol_value)
    else:
        norm[largest] += still_to_distribute
    return norm, table_log
