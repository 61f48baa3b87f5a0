"""Normalized-count header serialization (reference fse_compress.c:186-298,
entropy_common.c:41-144).

Variable-bit-width format: 4 bits of (tableLog - 5), then per-symbol fields
whose width shrinks as the remaining probability mass shrinks, with a
`previousIs0` run-length escape (2-bit repeats, 0xFFFF = 24 zeros) and a
threshold trick encoding values near the max in one fewer bit.
"""
from __future__ import annotations

from ..config import FSE_MIN_TABLELOG, FSE_TABLELOG_ABSOLUTE_MAX
from ..errors import (
    CorruptionError,
    FSEError,
    GENERIC,
    MAX_SYMBOL_VALUE_TOO_SMALL,
    TABLELOG_TOO_LARGE,
)

_M32 = 0xFFFFFFFF


def fse_write_ncount(norm, max_symbol_value: int, table_log: int) -> bytes:
    """Serialize normalized counts; mirrors FSE_writeNCount_generic (safe size)."""
    out = bytearray()
    bit_stream = 0
    bit_count = 0
    symbol = 0
    alphabet_size = max_symbol_value + 1
    previous_is0 = False

    table_size = 1 << table_log
    # header: tableLog
    bit_stream += (table_log - FSE_MIN_TABLELOG) << bit_count
    bit_count += 4

    remaining = table_size + 1  # +1 for extra accuracy
    threshold = table_size
    nb_bits = table_log + 1

    while symbol < alphabet_size and remaining > 1:
        if previous_is0:
            start = symbol
            while symbol < alphabet_size and not norm[symbol]:
                symbol += 1
            if symbol == alphabet_size:
                break  # incorrect distribution; mirrors reference break
            while symbol >= start + 24:
                start += 24
                bit_stream += 0xFFFF << bit_count
                bit_stream &= _M32
                out.append(bit_stream & 0xFF)
                out.append((bit_stream >> 8) & 0xFF)
                bit_stream >>= 16
            while symbol >= start + 3:
                start += 3
                bit_stream += 3 << bit_count
                bit_count += 2
            bit_stream += (symbol - start) << bit_count
            bit_count += 2
            if bit_count > 16:
                bit_stream &= _M32
                out.append(bit_stream & 0xFF)
                out.append((bit_stream >> 8) & 0xFF)
                bit_stream >>= 16
                bit_count -= 16
        count = norm[symbol]
        symbol += 1
        maxv = (2 * threshold - 1) - remaining
        remaining -= -count if count < 0 else count
        count += 1  # +1 for extra accuracy; -1 becomes 0
        if count >= threshold:
            count += maxv
        bit_stream += count << bit_count
        bit_count += nb_bits
        if count < maxv:
            bit_count -= 1
        previous_is0 = count == 1
        if remaining < 1:
            raise FSEError(GENERIC, "invalid distribution")
        while remaining < threshold:
            nb_bits -= 1
            threshold >>= 1
        if bit_count > 16:
            bit_stream &= _M32
            out.append(bit_stream & 0xFF)
            out.append((bit_stream >> 8) & 0xFF)
            bit_stream >>= 16
            bit_count -= 16

    if remaining != 1:
        raise FSEError(GENERIC, "incorrect normalized distribution")

    # flush
    bit_stream &= _M32
    out.append(bit_stream & 0xFF)
    out.append((bit_stream >> 8) & 0xFF)
    nbytes_tail = (bit_count + 7) // 8
    # the two bytes above stand for out[0..1] at the current position; trim
    return bytes(out[: len(out) - 2 + nbytes_tail])


def fse_read_ncount(data: bytes, max_symbol_value: int = 255):
    """Parse an NCount header.

    Returns (norm list, max_symbol_value, table_log, bytes_consumed).
    Mirrors FSE_readNCount (entropy_common.c:41-144) including its
    end-of-buffer clamping, so corrupted input raises instead of overreading.
    """
    hb_size = len(data)
    if hb_size < 4:
        buf = bytes(data) + b"\x00" * (4 - hb_size)
        norm, max_sv, table_log, used = fse_read_ncount(buf, max_symbol_value)
        if used > hb_size:
            raise CorruptionError("ncount: truncated header")
        return norm, max_sv, table_log, used

    norm = [0] * (max_symbol_value + 1)
    ip = 0
    iend = hb_size
    bit_stream = int.from_bytes(data[0:4], "little")
    nb_bits = (bit_stream & 0xF) + FSE_MIN_TABLELOG
    if nb_bits > FSE_TABLELOG_ABSOLUTE_MAX:
        raise FSEError(TABLELOG_TOO_LARGE)
    bit_stream >>= 4
    bit_count = 4
    table_log = nb_bits
    remaining = (1 << nb_bits) + 1
    threshold = 1 << nb_bits
    nb_bits += 1
    charnum = 0
    previous0 = False

    def le32(pos):
        return int.from_bytes(data[pos : pos + 4].ljust(4, b"\x00"), "little")

    while remaining > 1 and charnum <= max_symbol_value:
        if previous0:
            n0 = charnum
            while (bit_stream & 0xFFFF) == 0xFFFF:
                n0 += 24
                if ip < iend - 5:
                    ip += 2
                    bit_stream = le32(ip) >> bit_count
                else:
                    bit_stream >>= 16
                    bit_count += 16
            while (bit_stream & 3) == 3:
                n0 += 3
                bit_stream >>= 2
                bit_count += 2
            n0 += bit_stream & 3
            bit_count += 2
            if n0 > max_symbol_value:
                raise FSEError(MAX_SYMBOL_VALUE_TOO_SMALL)
            while charnum < n0:
                norm[charnum] = 0
                charnum += 1
            if ip <= iend - 7 or ip + (bit_count >> 3) <= iend - 4:
                ip += bit_count >> 3
                bit_count &= 7
                bit_stream = le32(ip) >> bit_count
            else:
                bit_stream >>= 2
        maxv = (2 * threshold - 1) - remaining
        if (bit_stream & (threshold - 1)) < maxv:
            count = bit_stream & (threshold - 1)
            bit_count += nb_bits - 1
        else:
            count = bit_stream & (2 * threshold - 1)
            if count >= threshold:
                count -= maxv
            bit_count += nb_bits
        count -= 1  # extra accuracy; -1 means low-prob
        remaining -= -count if count < 0 else count
        norm[charnum] = count
        charnum += 1
        previous0 = not count
        while remaining < threshold:
            nb_bits -= 1
            threshold >>= 1
        if ip <= iend - 7 or ip + (bit_count >> 3) <= iend - 4:
            ip += bit_count >> 3
            bit_count &= 7
        else:
            bit_count -= 8 * (iend - 4 - ip)
            ip = iend - 4
        bit_stream = le32(ip) >> (bit_count & 31)

    if remaining != 1:
        raise CorruptionError("ncount: remaining != 1")
    if bit_count > 32:
        raise CorruptionError("ncount: bitCount overflow")
    max_sv = charnum - 1
    ip += (bit_count + 7) >> 3
    return norm[: max_sv + 1], max_sv, table_log, ip
