"""On-device FSE count normalization (reference fse_compress.c:316-494).

Bit-identical to the host twin refimpl/norm.py, vectorised over a batch
of groups as [G, S] int64 tensor ops, so the resident compress never
pulls counts to the host.  The JAX package emulates the reference's U64
arithmetic with 16- and 21-bit limbs because the TPU has no 64-bit
integers; the GPU has them, so this is a direct transcription.  Every
intermediate stays below 2^63: c*step <= 2^62 on the main path, and in
normalizeM2 (to_dist << vsl) + mid < 2^62 + 2^61 and the running total
of c*rStep is at most 2^vsl * (to_dist + 1).

The normalizeM2 fallback runs on the device too: real corpora take it
(Proba02 at the speed-mode tableLog 10, for every group).
"""
from __future__ import annotations

import torch

from ..refimpl.norm import _RTB_TABLE

_NOT_YET = -2


def _highbit(x: torch.Tensor) -> torch.Tensor:
    """Index of the highest set bit of x (refimpl highbit32; -1 for 0)."""
    powers = 1 << torch.arange(63, device=x.device, dtype=torch.int64)
    return (x[..., None] >= powers).sum(dim=-1) - 1


def _first_max(v: torch.Tensor) -> torch.Tensor:
    """[G] index of the first maximum of each row (the reference's strict
    '>' scans), independent of how argmax breaks ties."""
    idx = torch.arange(v.shape[1], device=v.device)
    top = v.max(dim=1, keepdim=True).values
    return torch.where(v == top, idx, v.shape[1]).min(dim=1).values


def fse_normalize_batch(counts: torch.Tensor, totals: torch.Tensor,
                        table_log: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched FSE_normalizeCount: counts [G, S] (zero past maxSV), totals
    [G] -> (norm [G, S] int32, flags [G] int32).

    flags: 0 ok, 1 RLE (some count equals the total; the norm row is
    meaningless), 2 normalizeM2 underflow, 3 tableLog too small for the
    distribution (for 2 and 3 the host twin raises).  RLE takes precedence
    over 3, and 3 over 2.  Caller guarantees 5 <= table_log <= 13 and
    totals >= 1; there is no upper bound on the totals (a 4 MiB group
    is 2^22)."""
    tlog = table_log
    scale = 62 - tlog
    G, S = counts.shape
    dev = counts.device
    c = counts.to(torch.int64)
    total = totals.to(torch.int64)[:, None]                   # [G, 1]
    idx = torch.arange(S, device=dev)[None, :]

    max_sv = torch.where(c > 0, idx, -1).max(dim=1).values   # [G]
    rle = (c == total).any(dim=1)
    min_bits = torch.minimum(_highbit(total[:, 0]) + 1,
                             _highbit(max_sv) + 2)
    too_small = tlog < min_bits

    # ---- main path (fse_compress.c:435-494) ----
    step = (1 << 62) // total
    low_threshold = total >> tlog
    cs = c * step
    proba = cs >> scale
    # rtbTable[proba] (fse_compress.c:445) by selects: a table copied up
    # from host memory would wait for the device's queue (a pageable copy)
    rtb = torch.zeros_like(proba)
    for k, v in enumerate(_RTB_TABLE[1:], 1):
        rtb = torch.where(proba == k, v, rtb)
    rest_to_beat = (1 << (scale - 20)) * rtb
    proba = torch.where((proba < 8) & (cs - (proba << scale) > rest_to_beat),
                        proba + 1, proba)
    low = (c > 0) & (c <= low_threshold)
    part = c > low_threshold
    norm_main = torch.where(low, -1, torch.where(part, proba, 0))
    still = ((1 << tlog) - low.sum(dim=1)
             - torch.where(part, proba, 0).sum(dim=1))        # [G]
    vals = torch.where(part & (proba > 0), proba, 0)
    largest = torch.where(vals.max(dim=1).values > 0, _first_max(vals), 0)
    n_larg = norm_main.gather(1, largest[:, None])[:, 0]
    use_m2 = -still >= (n_larg >> 1)
    norm_main = norm_main + torch.where(idx == largest[:, None],
                                        still[:, None], 0)

    # ---- normalizeM2 fallback (fse_compress.c:348-432) ----
    low_one = (total * 3) >> (tlog + 1)
    cat = torch.where(c == 0, 0, torch.where(
        c <= low_threshold, -1, torch.where(c <= low_one, 1, _NOT_YET)))
    given = (cat == -1) | (cat == 1)
    distributed = given.sum(dim=1)
    tot1 = total[:, 0] - torch.where(given, c, 0).sum(dim=1)
    to_dist = (1 << tlog) - distributed
    done0 = to_dist == 0

    widen = (to_dist > 0) & (tot1 // to_dist.clamp(min=1) > low_one[:, 0])
    low_one2 = (tot1 * 3) // (2 * to_dist).clamp(min=1)
    upg = (cat == _NOT_YET) & (c <= low_one2[:, None]) & widen[:, None]
    cat = torch.where(upg, 1, cat)
    distributed = distributed + upg.sum(dim=1)
    tot2 = tot1 - torch.where(upg, c, 0).sum(dim=1)
    to_dist = (1 << tlog) - distributed

    all_low = distributed == max_sv + 1
    zero_total = ~all_low & (tot2 == 0)

    # round-robin +1 over the positive symbols, in symbol order
    pos1 = cat == 1
    npos = pos1.sum(dim=1).clamp(min=1)
    rank1 = torch.cumsum(pos1.to(torch.int64), dim=1) - 1
    rr_add = torch.where(pos1, (to_dist // npos)[:, None]
                         + (rank1 < (to_dist % npos)[:, None]), 0)

    # fractional distribution: rStep = ((to_dist << vsl) + mid) // total
    vsl = scale
    mid = (1 << (vsl - 1)) - 1
    r_step = ((to_dist << vsl) + mid) // tot2.clamp(min=1)
    ny = cat == _NOT_YET
    prod = torch.where(ny, c * r_step[:, None], 0)
    end = mid + torch.cumsum(prod, dim=1)
    weight = (end >> vsl) - ((end - prod) >> vsl)
    live = ~done0 & ~all_low & ~zero_total
    m2_err = ((ny & (weight < 1)).any(dim=1) & live
              # the reference would round-robin forever over no positive
              # symbol; surfaced as an error (unreachable at tableLog >= 9)
              | (zero_total & ~pos1.any(dim=1) & (to_dist > 0) & ~done0))

    norm_m2 = torch.where(ny, weight, cat)
    norm_m2 = torch.where(zero_total[:, None], cat + rr_add, norm_m2)
    mfs = _first_max(c)
    norm_m2 = torch.where(all_low[:, None],
                          cat + torch.where(idx == mfs[:, None],
                                            to_dist[:, None], 0),
                          norm_m2)
    norm_m2 = torch.where(done0[:, None], cat, norm_m2)

    norm = torch.where(use_m2[:, None], norm_m2, norm_main)
    flags = torch.where(rle, 1, torch.where(
        too_small, 3, torch.where(use_m2 & m2_err, 2, 0)))
    return norm.to(torch.int32), flags.to(torch.int32)
