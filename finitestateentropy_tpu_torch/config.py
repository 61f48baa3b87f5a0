"""Wire-format constants the port's host code needs.

Copies of the frozen contract in the JAX package's config.py (reference
lib/fse.h:636-683, lib/huf.h:117-133, lib/fseU16.c:43-57,
programs/fileio.c:121-129).  Changing any of them breaks
byte-compatibility.
"""
from __future__ import annotations

import dataclasses

# --- FSE (byte symbols) --- reference lib/fse.h:636-683
FSE_MAX_MEMORY_USAGE = 14
FSE_DEFAULT_MEMORY_USAGE = 13
FSE_MAX_TABLELOG = FSE_MAX_MEMORY_USAGE - 2          # 12
FSE_DEFAULT_TABLELOG = FSE_DEFAULT_MEMORY_USAGE - 2  # 11
FSE_MIN_TABLELOG = 5
FSE_TABLELOG_ABSOLUTE_MAX = 15
FSE_MAX_SYMBOL_VALUE = 255
FSE_NCOUNTBOUND = 512


def fse_tablestep(table_size: int) -> int:
    """Spread step: (size>>1) + (size>>3) + 3 (reference lib/fse.h:683)."""
    return (table_size >> 1) + (table_size >> 3) + 3


def fse_blockbound(size: int) -> int:
    """Worst-case FSE payload size (reference lib/fse.h:291)."""
    return size + (size >> 7) + 4 + 8


def fse_compressbound(size: int) -> int:
    """Worst-case full FSE block (header + payload), lib/fse.h:292."""
    return FSE_NCOUNTBOUND + fse_blockbound(size)


# --- Huff0 --- reference lib/huf.h:72,117-133
HUF_TABLELOG_MAX = 12
HUF_TABLELOG_DEFAULT = 11
HUF_TABLELOG_ABSOLUTEMAX = 15
HUF_SYMBOLVALUE_MAX = 255
HUF_BLOCKSIZE_MAX = 128 * 1024
HUF_CTABLEBOUND = 129


def huf_blockbound(size: int) -> int:
    return size + (size >> 8) + 8


def huf_compressbound(size: int) -> int:
    return HUF_CTABLEBOUND + huf_blockbound(size)


# --- FSE_U16 (16-bit symbols) --- reference lib/fseU16.c:43-57, lib/fseU16.h:46-55
FSEU16_MAX_MEMORY_USAGE = 15
FSEU16_DEFAULT_MEMORY_USAGE = 14
FSEU16_MAX_TABLELOG = FSEU16_MAX_MEMORY_USAGE - 2          # 13
FSEU16_DEFAULT_TABLELOG = FSEU16_DEFAULT_MEMORY_USAGE - 2  # 12
FSEU16_MAX_SYMBOL_VALUE = 286
FSEU16_SYMBOLVALUE_ABSOLUTEMAX = 4095

# --- Frame format --- reference programs/fileio.c:121-129
FIO_MAGIC_FSE = 0x183E2309
FIO_MAGIC_HUF = 0x183E3309
FIO_MAGIC_ZLIBH = 0x183E4309
FIO_MAX_BLOCKSIZE_ID = 6     # 64 KB
FIO_BLOCKSIZEID_DEFAULT = 5  # 32 KB
FIO_FRAMEHEADERSIZE = 5
FIO_MAX_BLOCKHEADERSIZE = 5
FSE_CHECKSUM_SEED = 0

# Block types, fileio.c:137
BT_COMPRESSED = 0
BT_RAW = 1
BT_RLE = 2
BT_CRC = 3


@dataclasses.dataclass
class CodecConfig:
    """Runtime configuration for the batched device codec (the JAX
    package's CodecConfig, field for field)."""

    codec: str = "fse"            # "fse" | "huf" | "u16" | "auto"
    block_size_id: int = FIO_BLOCKSIZEID_DEFAULT
    table_log: int = 0            # 0 = codec default
    max_symbol_value: int = 0     # 0 = codec default
    # device / mesh knobs
    batch_blocks: int = 0         # 0 = all blocks in one device batch
    mesh_shape: tuple = ()        # () = single device; e.g. (8,) data-parallel

    @property
    def block_size(self) -> int:
        return 1 << (10 + self.block_size_id)
