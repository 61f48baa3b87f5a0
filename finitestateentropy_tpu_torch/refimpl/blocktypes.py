"""Block compression result conventions.

The reference encodes three outcomes in its size_t return value
(lib/fse.h:59-66): 0 == not compressible (store raw), 1 == RLE (one repeated
symbol), n>1 == n compressed bytes.  Host twin uses an explicit enum.
"""
from __future__ import annotations

import dataclasses
import enum


class Kind(enum.IntEnum):
    COMPRESSED = 0
    RAW = 1
    RLE = 2


@dataclasses.dataclass
class BlockResult:
    kind: Kind
    data: bytes = b""   # compressed payload (COMPRESSED) or empty

    @classmethod
    def raw(cls):
        return cls(Kind.RAW)

    @classmethod
    def rle(cls):
        return cls(Kind.RLE)

    @classmethod
    def compressed(cls, data: bytes):
        return cls(Kind.COMPRESSED, data)
