"""Histogram (reference lib/hist.c).

The counting itself is order-independent, so numpy bincount is exactly
equivalent to the reference's 4-table ILP scan; only the returned
(count, maxSymbolValue, maxCount) contract must match (hist.c:29-54,126-131).
"""
from __future__ import annotations

import numpy as np

from ..errors import FSEError, MAX_SYMBOL_VALUE_TOO_SMALL


def hist_count(src, max_symbol_value: int = 255, check: bool = True):
    """Return (count[maxSV+1], true_max_symbol, largest_count).

    `count` is trimmed to the true max symbol (reference updates *maxSVPtr).
    """
    arr = np.frombuffer(bytes(src), dtype=np.uint8) if not isinstance(src, np.ndarray) else src
    if arr.size == 0:
        return np.zeros(1, dtype=np.uint32), 0, 0
    counts = np.bincount(arr, minlength=max_symbol_value + 1).astype(np.uint32)
    true_max = int(np.max(arr))
    if check and true_max > max_symbol_value:
        raise FSEError(MAX_SYMBOL_VALUE_TOO_SMALL)
    largest = int(counts.max())
    return counts[: true_max + 1], true_max, largest
