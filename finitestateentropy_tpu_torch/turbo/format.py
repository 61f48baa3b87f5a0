"""TurboRANS lane layout (copy of the JAX package's turbo/format.py:43-71).

Symbol <-> lane mapping (N = n_sym padded up to a multiple of 4096): lane
k = r*128 + l handles bytes i = 4*(t4*1024 + k) + p at decode step
t = 4*t4 + p, so a decoder's per-step output of 1024 packed u32 words lands
in ascending memory order with no transposition.  On the GPU lane k is
thread k of a 1024-thread block (encode) or thread l of row r's 128-thread
block (decode).
"""
from __future__ import annotations

import numpy as np

TURBO_LANES = 1024          # K: interleaved coder states per group
TURBO_STEP_SYMS = 4096      # symbols per supercycle (4 bytes per lane slot)


def _pad_n(n: int) -> int:
    return (n + TURBO_STEP_SYMS - 1) // TURBO_STEP_SYMS * TURBO_STEP_SYMS


def _lane_view(src_pad: np.ndarray):
    """[N] bytes -> [T, 1024] symbol matrix in (decode step, lane) order.

    Byte i = 4*(t4*1024 + k) + p is handled by lane k at step 4*t4 + p:
    reshape to [T4, 1024, 4] then transpose the last two axes into steps.
    """
    t4 = src_pad.shape[0] // TURBO_STEP_SYMS
    m = src_pad.reshape(t4, TURBO_LANES, 4)
    return m.transpose(0, 2, 1).reshape(t4 * 4, TURBO_LANES)


def _unlane_view(sym_mat: np.ndarray) -> np.ndarray:
    t = sym_mat.shape[0]
    m = sym_mat.reshape(t // 4, 4, TURBO_LANES).transpose(0, 2, 1)
    return m.reshape(t * TURBO_LANES)
