"""The reference's NCount reader (FSE_readNCount, lib/entropy_common.c),
in plain Python: the normalized counts a TurboRANS group header carries.

Frozen here so that the benchmark's reference decoder shares no code with
the program it judges.
"""
from __future__ import annotations

MIN_TABLELOG = 5
TABLELOG_ABSOLUTE_MAX = 15


class FrameError(ValueError):
    """A frame that the reference cannot read."""


def read_ncount(data: bytes, max_symbol_value: int = 255):
    """(norm list, max symbol value, tableLog, bytes used) of an NCount
    header, with FSE_readNCount's end-of-buffer clamping."""
    hb_size = len(data)
    if hb_size < 4:
        norm, max_sv, table_log, used = read_ncount(
            bytes(data) + b"\x00" * (4 - hb_size), max_symbol_value)
        if used > hb_size:
            raise FrameError("ncount truncated")
        return norm, max_sv, table_log, used

    def le32(pos):
        return int.from_bytes(data[pos:pos + 4].ljust(4, b"\x00"), "little")

    norm = [0] * (max_symbol_value + 1)
    ip, iend = 0, hb_size
    bit_stream = le32(0)
    nb_bits = (bit_stream & 0xF) + MIN_TABLELOG
    if nb_bits > TABLELOG_ABSOLUTE_MAX:
        raise FrameError("ncount tableLog too large")
    bit_stream >>= 4
    bit_count = 4
    table_log = nb_bits
    remaining = (1 << nb_bits) + 1
    threshold = 1 << nb_bits
    nb_bits += 1
    charnum = 0
    previous0 = False
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
                raise FrameError("ncount symbol out of range")
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
        count -= 1                      # -1 is a low-probability symbol
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
        raise FrameError("ncount: remaining != 1")
    if bit_count > 32:
        raise FrameError("ncount: bitCount overflow")
    max_sv = charnum - 1
    ip += (bit_count + 7) >> 3
    return norm[:max_sv + 1], max_sv, table_log, ip
