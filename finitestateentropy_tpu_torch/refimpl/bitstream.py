"""LIFO bitstream, 64-bit-register semantics (reference lib/bitstream.h).

Contract highlights (bitstream.h:53-56, 254-260, 272-318, 416-440):
  * written forward, read backward;
  * writer accumulates into a 64-bit register, explicit flushes write the
    register little-endian and advance by whole bytes;
  * stream is closed with a single 1 "endMark" bit, and its byte length is
    ``(ptr - start) + (bitPos > 0)``;
  * reader starts from the last byte, locating the start bit via the highest
    set bit of the final byte, and reloads a 64-bit window backwards with a
    >= 57 usable-bit guarantee while `unfinished`.
"""
from __future__ import annotations

import numpy as np

_M64 = (1 << 64) - 1

# reload status (bitstream.h:99-103)
UNFINISHED = 0
END_OF_BUFFER = 1
COMPLETED = 2
OVERFLOW = 3


def highbit32(v: int) -> int:
    """Index of the highest set bit (v != 0)."""
    return v.bit_length() - 1


class BitWriter:
    """Forward bit writer with 64-bit register semantics.

    The destination is a bytearray of fixed capacity; `close()` reports the
    stream size, or 0 if the data did not fit (matching BIT_closeCStream).
    """

    __slots__ = ("buf", "container", "bitpos", "pos", "end")

    def __init__(self, capacity: int):
        if capacity <= 8:
            raise ValueError("bitstream capacity must exceed register size")
        self.buf = bytearray(capacity + 8)  # slack so the LE64 store never truncates
        self.container = 0
        self.bitpos = 0
        self.pos = 0
        self.end = capacity - 8   # endPtr

    def add_bits(self, value: int, nbits: int) -> None:
        """Append the low `nbits` of value (masked) — BIT_addBits."""
        self.container |= (value & ((1 << nbits) - 1)) << self.bitpos
        self.bitpos += nbits

    def flush(self) -> None:
        """BIT_flushBits (safe variant: clamps pos to endPtr)."""
        nbytes = self.bitpos >> 3
        self.buf[self.pos : self.pos + 8] = (self.container & _M64).to_bytes(8, "little")
        self.pos += nbytes
        if self.pos > self.end:
            self.pos = self.end
        self.bitpos &= 7
        self.container = (self.container & _M64) >> (nbytes * 8)

    def close(self) -> int:
        """Append endMark, flush; returns byte size or 0 on overflow."""
        self.add_bits(1, 1)
        self.flush()
        if self.pos >= self.end:
            return 0
        return self.pos + (1 if self.bitpos > 0 else 0)

    def bytes(self, size: int) -> bytes:
        return bytes(self.buf[:size])


class BitReader:
    """Backward bit reader — BIT_DStream_t semantics."""

    __slots__ = ("src", "container", "bits_consumed", "ptr", "start", "limit")

    def __init__(self, src: bytes):
        n = len(src)
        if n < 1:
            from ..errors import FSEError, SRC_SIZE_WRONG

            raise FSEError(SRC_SIZE_WRONG, "empty bitstream")
        self.src = src
        self.start = 0
        self.limit = 8  # limitPtr
        last = src[n - 1]
        if n >= 8:
            self.ptr = n - 8
            self.container = int.from_bytes(src[self.ptr : self.ptr + 8], "little")
            if last == 0:
                from ..errors import CorruptionError

                raise CorruptionError("endMark not present")
            self.bits_consumed = 8 - highbit32(last)
        else:
            self.ptr = 0
            self.container = int.from_bytes(src[:n], "little")
            if last == 0:
                from ..errors import CorruptionError

                raise CorruptionError("endMark not present")
            self.bits_consumed = (8 - highbit32(last)) + (8 - n) * 8

    def look_bits(self, nbits: int) -> int:
        """BIT_lookBits: next nbits without consuming (register only)."""
        start = (64 - self.bits_consumed - nbits) & 63
        return (self.container >> start) & ((1 << nbits) - 1)

    def look_bits_fast(self, nbits: int) -> int:
        """BIT_lookBitsFast (nbits >= 1)."""
        return ((self.container << (self.bits_consumed & 63)) & _M64) >> ((64 - nbits) & 63)

    def skip_bits(self, nbits: int) -> None:
        self.bits_consumed += nbits

    def read_bits(self, nbits: int) -> int:
        v = self.look_bits(nbits)
        self.bits_consumed += nbits
        return v

    def read_bits_fast(self, nbits: int) -> int:
        v = self.look_bits_fast(nbits)
        self.bits_consumed += nbits
        return v

    def reload_fast(self) -> int:
        if self.ptr < self.limit:
            return OVERFLOW
        self.ptr -= self.bits_consumed >> 3
        self.bits_consumed &= 7
        self.container = int.from_bytes(self.src[self.ptr : self.ptr + 8], "little")
        return UNFINISHED

    def reload(self) -> int:
        """BIT_reloadDStream."""
        if self.bits_consumed > 64:
            return OVERFLOW
        if self.ptr >= self.limit:
            return self.reload_fast()
        if self.ptr == self.start:
            return END_OF_BUFFER if self.bits_consumed < 64 else COMPLETED
        nbytes = self.bits_consumed >> 3
        result = UNFINISHED
        if self.ptr - nbytes < self.start:
            nbytes = self.ptr - self.start
            result = END_OF_BUFFER
        self.ptr -= nbytes
        self.bits_consumed -= nbytes * 8
        self.container = int.from_bytes(self.src[self.ptr : self.ptr + 8], "little")
        return result

    def end_of_stream(self) -> bool:
        return self.ptr == self.start and self.bits_consumed == 64
