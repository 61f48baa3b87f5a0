"""The `fse -e` path of the CLI from host memory to host memory:
io.frame.compress_bytes(data, codec, block_size_id, compressor) and
io.frame.decompress_bytes(frame, decompressor), the public functions the
CLI's compat path calls, behind the device codec that get_batch_codec(codec,
mesh, block_size, device) builds once; the configuration's "compress_args"
give the codec, blockSizeID and mesh.

On the CPU (the harness's tests) the CLI's `--device host` path stands in:
the host twins (compressor and decompressor None), since the plain versions
of the FSE kernels step a block's chain one symbol at a time in torch ops,
seconds a call even at a few KiB.
"""
from __future__ import annotations

import numpy as np


class System:
    def __init__(self, config: dict, device: str):
        from finitestateentropy_tpu_torch.io import frame
        from finitestateentropy_tpu_torch.models import get_batch_codec

        args = config["compress_args"]
        self.frame = frame
        self.codec, self.bid = args["codec"], int(args["block_size_id"])
        self.compressor = self.decompressor = None
        if device != "cpu":
            self.compressor, self.decompressor = get_batch_codec(
                self.codec, mesh=int(args["mesh"]), block_size=1 << (10 + self.bid),
                device=device)

    def load(self, buf: np.ndarray) -> bytes:
        return buf.tobytes()

    def compress(self, data: bytes) -> bytes:
        return self.frame.compress_bytes(data, self.codec, self.bid, self.compressor)

    def decompress(self, frame: bytes) -> bytes:
        return self.frame.decompress_bytes(frame, self.decompressor)

    @staticmethod
    def nbytes(out: bytes) -> int:
        return len(out)

    @staticmethod
    def same(out: bytes, data: bytes) -> bool:
        return out == data

    def trace_begin(self) -> None:
        """The frame layer and the device codec mark their stages
        ("frame.<stage>", "fse.<stage>"); no stage seconds, so nothing
        syncs."""

    def trace_end(self) -> dict:
        return {}
