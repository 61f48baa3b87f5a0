"""The u16 lane interleave (copy of the JAX package's turbo/rans16.py:35-57).

Only the layout helpers the pair wire needs: each output i32 word carries
2 u16 symbols, so a supercycle is 2 steps, and symbol i = 2*(t2*1024 + k)
+ p is handled by lane k at step 2*t2 + p.  The TurboRANS-U16 codec itself
(16-bit symbol alphabets) is not ported yet (ROADMAP.md queue A item 6).
The tests hold each helper equal to its original.
"""
from __future__ import annotations

import numpy as np

from .format import TURBO_LANES

RANS16_STEP_SYMS = 2048        # symbols per supercycle (2 per lane slot)


def _pad_n16(n: int) -> int:
    return (n + RANS16_STEP_SYMS - 1) // RANS16_STEP_SYMS * RANS16_STEP_SYMS


def _lane_view16(src_pad: np.ndarray):
    """[N] u16 symbols -> [T, 1024] in (decode step, lane) order."""
    t2 = src_pad.shape[0] // RANS16_STEP_SYMS
    m = src_pad.reshape(t2, TURBO_LANES, 2)
    return m.transpose(0, 2, 1).reshape(t2 * 2, TURBO_LANES)


def _unlane_view16(sym_mat: np.ndarray) -> np.ndarray:
    t = sym_mat.shape[0]
    m = sym_mat.reshape(t // 2, 2, TURBO_LANES).transpose(0, 2, 1)
    return m.reshape(t * TURBO_LANES)
