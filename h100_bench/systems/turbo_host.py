"""The TurboRANS entry points from host memory to host memory:
turbo_compress_device(data) and turbo_decompress_device(blob), with the
flags of the configuration's "compress_args" and "decompress_args"."""
from __future__ import annotations

from contextlib import contextmanager

import numpy as np


class System:
    def __init__(self, config: dict, device: str):
        from finitestateentropy_tpu_torch.turbo import api

        self.api = api
        self.device = device
        self.c_args = dict(config["compress_args"])
        self.d_args = dict(config["decompress_args"])
        self._stage = None

    def load(self, buf: np.ndarray) -> bytes:
        return buf.tobytes()

    def compress(self, data: bytes) -> bytes:
        return self.api.turbo_compress_device(data, **self.c_args,
                                              device=self.device)

    def decompress(self, frame: bytes) -> bytes:
        return self.api.turbo_decompress_device(frame, **self.d_args,
                                                device=self.device)

    @staticmethod
    def nbytes(out: bytes) -> int:
        return len(out)

    @staticmethod
    def same(out: bytes, data: bytes) -> bool:
        return out == data

    def trace_begin(self) -> None:
        """Turn on the entry points' stage seconds (each stage then ends in
        a device sync) and mark each stage in the trace as "api.<stage>"."""
        from torch.profiler import record_function

        stage = self._stage = self.api._stage

        @contextmanager
        def marked(name, dev):
            with record_function("api." + name), stage(name, dev):
                yield

        self.api._stage = marked
        self.api.stage_seconds = {}

    def trace_end(self) -> dict:
        """The stage seconds summed since trace_begin; both hooks off."""
        stages = dict(self.api.stage_seconds or {})
        self.api.stage_seconds = None
        self.api._stage = self._stage
        return stages
