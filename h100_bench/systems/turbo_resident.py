"""The device-resident TurboRANS entries: rans_compress_resident(x) on a
1-D uint8 tensor in device memory, returning host frames, and
rans_decompress_resident(blob), returning a tensor in device memory (the
call ends when the device has finished it)."""
from __future__ import annotations

import numpy as np
import torch


class System:
    def __init__(self, config: dict, device: str):
        from finitestateentropy_tpu_torch.turbo import device_api

        self.api = device_api
        self.device = torch.device(device)
        self.c_args = dict(config["compress_args"])
        self.d_args = dict(config["decompress_args"])

    def load(self, buf: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(buf).to(self.device)

    def _done(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def compress(self, x: torch.Tensor) -> bytes:
        return self.api.rans_compress_resident(x, **self.c_args)

    def decompress(self, frame: bytes) -> torch.Tensor:
        out = self.api.rans_decompress_resident(frame, **self.d_args,
                                                device=self.device)
        self._done()
        return out

    @staticmethod
    def nbytes(out: torch.Tensor) -> int:
        return int(out.numel())

    @staticmethod
    def same(out: torch.Tensor, x: torch.Tensor) -> bool:
        return out.shape == x.shape and bool(torch.equal(out, x))

    def trace_begin(self) -> None:
        """The resident entries mark their stages ("resident.<stage>")."""

    def trace_end(self) -> dict:
        return {}
