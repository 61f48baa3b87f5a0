"""FSE_U16 pipeline: batched 16-bit-symbol streams (reference lib/fseU16.h).

The reference's fseU16 is a library-only codec — there is no frame format
for 16-bit symbols (fseU16.h:40-55), so this pipeline exposes a *stream*
interface rather than the byte-block frame interface:

    compress_streams(list[np.ndarray u16]) -> list[bytes]
    decompress_streams(list[(payload, n_symbols)]) -> list[np.ndarray u16]

Three wire modes, each with the JAX package's bytes:
  * wire="compat": bytes identical to the reference FSE_compressU16
    (fseU16.c:203-251), via the host twin behind a one-byte tag — the
    interchange format.
  * wire="turbo": the TurboRANS-U16 group format (turbo/rans16.py) through
    the entry points turbo16_compress_device / turbo16_decompress_device,
    the CUDA kernels (split-table kernels cover symbols up to the
    reference's absolute max 4095); device=None runs on CUDA,
    device="cpu" the kernels' plain versions.
  * wire="turbo_native": the same format through the native host codec
    (native.py); its frames interchange with the turbo wire's.
"""
from __future__ import annotations

import numpy as np

from ..config import FSEU16_SYMBOLVALUE_ABSOLUTEMAX
from ..refimpl.blocktypes import Kind
from ..refimpl.fseu16 import fse_compress_u16, fse_decompress_u16


class U16Codec:
    def __init__(self, wire: str = "compat", interpret: bool = False, device=None):
        if wire not in ("compat", "turbo", "turbo_native"):
            raise ValueError(f"unknown u16 wire {wire!r}")
        self.wire = wire
        self.interpret = interpret
        self.device = device

    # -- compat wire: reference FSE_compressU16 bytes ----------------------

    def _compress_compat(self, streams):
        out = []
        for s in streams:
            s = np.ascontiguousarray(s, dtype=np.uint16)
            msv = int(s.max(initial=0))
            if msv > FSEU16_SYMBOLVALUE_ABSOLUTEMAX:
                # beyond the codec's absolute alphabet limit (fseU16.c:54):
                # store raw rather than erroring out of a batch
                out.append(b"\x00" + s.tobytes())
                continue
            r = fse_compress_u16(s, max_symbol_value=max(msv, 1))
            if r.kind == Kind.COMPRESSED:
                out.append(b"\x02" + r.data)
            elif r.kind == Kind.RLE:
                out.append(b"\x01" + s[:1].tobytes())
            else:
                out.append(b"\x00" + s.tobytes())
        return out

    def _decompress_compat(self, items):
        out = []
        for payload, n in items:
            tag, body = payload[0], payload[1:]
            if tag == 0:
                out.append(np.frombuffer(body, "<u2")[:n].copy())
            elif tag == 1:
                out.append(np.full(n, np.frombuffer(body, "<u2")[0], np.uint16))
            else:
                out.append(fse_decompress_u16(
                    body, n, max_symbol_value=FSEU16_SYMBOLVALUE_ABSOLUTEMAX))
        return out

    # -- turbo wire: the entry points, the CUDA kernels ----------------------

    def _compress_turbo(self, streams):
        from ..turbo.api import turbo16_compress_device

        return [turbo16_compress_device(np.ascontiguousarray(s, np.uint16),
                                        interpret=self.interpret, device=self.device)
                for s in streams]

    def _decompress_turbo(self, items):
        from ..turbo.api import turbo16_decompress_device

        return [turbo16_decompress_device(p, interpret=self.interpret,
                                          device=self.device)[:n]
                for p, n in items]

    # -- turbo wire, native host codec (no GPU needed; frames interchange
    # with the device path — the native decoder reads v1 AND v2 frames) ----

    def _compress_turbo_native(self, streams):
        from .. import native

        return [native.rans16_compress_native(
            np.ascontiguousarray(s, np.uint16)) for s in streams]

    def _decompress_turbo_native(self, items):
        from .. import native

        return [native.rans16_decompress_native(p)[:n] for p, n in items]

    # -- public batch interface --------------------------------------------

    def compress_streams(self, streams):
        if self.wire == "compat":
            return self._compress_compat(streams)
        if self.wire == "turbo_native":
            return self._compress_turbo_native(streams)
        return self._compress_turbo(streams)

    def decompress_streams(self, items):
        if self.wire == "compat":
            return self._decompress_compat(items)
        if self.wire == "turbo_native":
            return self._decompress_turbo_native(items)
        return self._decompress_turbo(items)
