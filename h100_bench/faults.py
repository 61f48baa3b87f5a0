"""Broken systems for the check of the check: each wraps a system and
breaks one guarantee, so that a run with it has to come out not correct.

- control: a private wire.  The frames are the program's with every byte
  after the first group header flipped, and decompress flips them back
  first: the round trip stays lossless, but no reader of the TurboRANS
  format can read the frames.  It is what a change of the wire for speed
  would look like, and only the reference can catch it.
- stale_frame: compress returns the frame of its previous call (a state
  left unchanged).
- half_output: decompress returns the first half of its output (half of
  the groups left out).
- altered_output: decompress flips one byte of its output.
- altered_frame: compress flips one byte in the middle of its frame.

The one-chip cells have no exchange between chips to leave out.
"""
from __future__ import annotations

import numpy as np
import torch

HEADER = 16


def _flip(data, pos: int):
    if isinstance(data, torch.Tensor):
        out = data.clone()
        out[pos] ^= 1
        return out
    b = bytearray(data)
    b[pos] ^= 1
    return bytes(b)


def _flip_tail(frame: bytes) -> bytes:
    b = np.frombuffer(frame, np.uint8).copy()
    b[HEADER:] ^= 0xFF
    return b.tobytes()


class Broken:
    def __init__(self, system, fault: str):
        if fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")
        self.system, self.fault = system, fault
        self.last = None

    def __getattr__(self, name):
        return getattr(self.system, name)

    def compress(self, x):
        frame = self.system.compress(x)
        if self.fault == "control":
            return _flip_tail(frame)
        if self.fault == "altered_frame":
            return _flip(frame, len(frame) // 2)
        if self.fault == "stale_frame":
            frame, self.last = self.last or frame, frame
        return frame

    def decompress(self, frame: bytes):
        if self.fault == "control":
            frame = _flip_tail(frame)
        out = self.system.decompress(frame)
        if self.fault == "half_output":
            return out[: len(out) // 2]
        if self.fault == "altered_output":
            return _flip(out, len(out) // 3)
        return out


FAULTS = ("control", "stale_frame", "half_output", "altered_output",
          "altered_frame")
