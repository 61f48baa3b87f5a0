"""Codec auto-selection: estimate per-codec compressed size, pick a winner.

The reference leaves codec choice to the user (-e/-h/-z) but documents the
tradeoff it implies (README.md:44-47): Huffman cannot beat 1 bit/symbol so
FSE wins ratio on skewed data, while Huff0 wins speed everywhere.  This
module makes that call automatically at the frame level: the Huffman side is
the reference's own exact estimator (HUF_estimateCompressedSize,
huf_compress.c:422-429 — sum of count[s]*nbBits[s] over the real
length-limited table), the FSE side is the Shannon bound plus measured
header overhead, and Huff0 is preferred unless FSE is more than a few
percent smaller (its decode path being the faster one, README.md:44-47).
"""
from __future__ import annotations

import math

import numpy as np

from ..config import HUF_TABLELOG_DEFAULT
from ..refimpl.hist import hist_count
from ..refimpl.huf import huf_build_ctable, huf_write_ctable
from ..refimpl.norm import fse_optimal_table_log

# FSE buys the slower decode only when it is at least this much smaller
# (Huff0 decode is ~3x FSE in the reference, README.md:32-33)
FSE_ADVANTAGE = 0.98


def huf_estimate_block(count: np.ndarray, max_sv: int, n: int) -> float:
    """Exact Huff0 cost in bytes: real table build + weight header size."""
    huff_log = fse_optimal_table_log(HUF_TABLELOG_DEFAULT, n, max_sv,
                                     minus=1, max_allowed=12)
    table = huf_build_ctable(count, max_sv, huff_log)
    header = huf_write_ctable(table, max_sv)
    bits = int(np.sum(count[: max_sv + 1].astype(np.int64)
                      * table.nb_bits[: max_sv + 1]))
    return len(header) + 6 + (bits + 7) // 8  # 6 = 4X jumpTable


def fse_estimate_block(count: np.ndarray, max_sv: int, n: int) -> float:
    """FSE cost in bytes: Shannon bound + NCount header estimate.

    The tANS coder tracks entropy to within ~0.05% (Duda, arXiv:1311.2540),
    so the Shannon bound is an accurate size estimate; the header estimate
    (~0.6 bytes/symbol present) matches measured NCount sizes."""
    c = count[: max_sv + 1].astype(np.float64)
    p = c[c > 0] / n
    bits = -n * float(np.sum(p * np.log2(p)))
    n_present = int(np.count_nonzero(c))
    return 0.6 * n_present + bits / 8


def choose_codec(blocks, max_sample: int = 8) -> str:
    """Pick 'fse' or 'huf' for a frame by sampling up to `max_sample` blocks.

    Raw/RLE-destined blocks are skipped (both codecs fall back identically
    at the frame layer, fileio.c:347-404 semantics)."""
    if not blocks:
        return "huf"
    stride = max(len(blocks) // max_sample, 1)
    fse_total = huf_total = raw_total = 0.0
    for b in blocks[::stride][:max_sample]:
        n = len(b)
        if n < 12:
            continue
        count, max_sv, largest = hist_count(b)
        if largest == n or largest <= (n >> 7) + 4:
            continue  # RLE / incompressible either way
        fse_total += fse_estimate_block(count, max_sv, n)
        huf_total += huf_estimate_block(count, max_sv, n)
        raw_total += n
    if raw_total == 0:
        return "huf"  # nothing compressible: choice is moot, take the fast one
    return "fse" if fse_total < FSE_ADVANTAGE * huf_total else "huf"
