"""Codec pipelines ("model families"): FSE, Huff0, FSE_U16 and auto-select.

The port of the JAX package's models/.  FSE / Huff0 / auto expose the batch
interface the frame layer (io/frame.py) consumes:
  compress_blocks(list[bytes]) -> list[BlockResult]
  decompress_blocks(list[(payload, regenerated_size)]) -> list[bytes]
The device codecs cross the host-device boundary once per batch.  FSE_U16
is stream-oriented (no frame format exists for 16-bit symbols, reference
fseU16.h:40-55): see u16_codec.U16Codec.
"""
from .fse_codec import FseTpuCodec
from .huf_codec import HufTpuCodec
from .select import choose_codec
from .u16_codec import U16Codec


class AutoTpuCodec:
    """Frame-level auto-select: picks FSE or Huff0 from block histograms
    (select.choose_codec) at compress time and delegates; `chosen` records
    the decision so callers can write the matching frame magic."""

    def __init__(self, block_size: int = 32768, mesh: int = 0, device=None):
        self.block_size = block_size
        self.mesh = mesh
        self.device = device
        self.chosen: str | None = None

    def _inner(self):
        return (FseTpuCodec if self.chosen == "fse" else HufTpuCodec)(
            block_size=self.block_size, mesh=self.mesh, device=self.device)

    def compress_blocks(self, blocks):
        self.chosen = choose_codec(blocks)
        return self._inner().compress_blocks(blocks)

    def decompress_blocks(self, items):
        # auto-select is a compress-time decision: the frame magic names the
        # codec, so decompression comes through get_batch_codec('fse'|'huf')
        # (the CLI reads the magic and does exactly that); guessing here
        # would silently mis-decode
        if self.chosen is None:
            raise ValueError(
                "AutoTpuCodec cannot decompress without a compress-time "
                "decision; read the frame magic and use the named codec "
                "(get_batch_codec('fse') or get_batch_codec('huf'))")
        return self._inner().decompress_blocks(items)


def get_batch_codec(codec: str, mesh: int = 0, block_size: int = 32768,
                    device=None):
    """Returns (BatchCompressor, BatchDecompressor) for the frame layer.

    block_size must be the frame's (1 << (10 + blockSizeID)); the JAX
    function builds its codecs at the 32 KiB default whatever the frame
    says."""
    kinds = {"fse": FseTpuCodec, "huf": HufTpuCodec, "auto": AutoTpuCodec}
    if codec not in kinds:
        raise ValueError(f"no device codec for {codec!r}")
    c = kinds[codec](block_size=block_size, mesh=mesh, device=device)
    return c.compress_blocks, c.decompress_blocks
