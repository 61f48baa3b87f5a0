"""On-device batched TurboRANS table builds.

Device twins of the host packers in turbo/tables.py (pack_rans_ctables,
pack_rans_dtable), over a batch of groups, so the resident pipeline
(hist -> normalize -> tables -> encode) never pulls counts to the host.
The layouts are the kernels' table contracts:

* encode: fc = (cumul << 12) | freq, magic = floor(2^32 / freq) as u32
  bits in i32 (f == 1 gives 0xFFFFFFFF, as the host packer clips it);
* decode: slot entry (cumul << 20) | (freq << 8) | sym.

Absent symbols (freq 0) get cumul = the sum of the freqs before them
here, where the host packers give unused entries their own values; a
well-formed stream never reads them, and the tests compare the used
entries.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def rans_freqs_batch(norm: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """norm [G, 256] (reference normalized counts, -1 = low probability,
    0 = absent) -> (freq [G, 256] int32 with absent symbols at 0,
    exclusive cumul [G, 256] int32)."""
    freq = torch.where(norm < 0, 1, norm).to(torch.int32)
    cumul = (torch.cumsum(freq, dim=1) - freq).to(torch.int32)
    return freq, cumul


def pack_rans_ctables_batch(norm: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """norm [G, 256] -> (fc [G, 2, 128], magic [G, 2, 128]) int32 encode
    tables (byte alphabet, 12-bit freq and cumul fields)."""
    freq, cumul = rans_freqs_batch(norm)
    f = freq.clamp(min=1).to(torch.int64)
    fc = (cumul.to(torch.int64) << 12) | f
    magic = ((1 << 32) // f).clamp(max=_M32)
    magic = torch.where(magic >= 1 << 31, magic - (1 << 32), magic)
    G = norm.shape[0]
    return (fc.to(torch.int32).view(G, 2, 128),
            magic.to(torch.int32).view(G, 2, 128))


def pack_rans_dtable_batch(norm: torch.Tensor, table_log: int) -> torch.Tensor:
    """norm [G, 256] -> [G, tch, 128] int32 decode tables, tch =
    max(2^tableLog / 128, 1); below tableLog 7 the entries past 2^tableLog
    are 0, as the host packer leaves them."""
    freq, cumul = rans_freqs_batch(norm)
    G = norm.shape[0]
    m = 1 << table_log
    slots = torch.arange(m, dtype=torch.int32, device=norm.device)
    # the last symbol whose cumul <= slot: absent symbols share the next
    # real symbol's cumul, so right=True skips them
    sym = torch.searchsorted(cumul, slots.expand(G, m).contiguous(),
                             right=True) - 1
    e = ((cumul.gather(1, sym).to(torch.int64) << 20)
         | (freq.gather(1, sym).to(torch.int64) << 8) | sym)
    e = torch.where(e >= 1 << 31, e - (1 << 32), e).to(torch.int32)
    n = max(m, 128)
    if n > m:
        e = torch.cat([e, e.new_zeros(G, n - m)], dim=1)
    return e.view(G, n // 128, 128)
