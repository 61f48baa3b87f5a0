"""Batched FSE table construction as torch tensor ops on the inputs' device.

The port of the JAX package's ops/fse_tables.py (XLA ops there, not a
per-symbol chain).  The reference's serial spread (fse_compress.c:108-128,
fse_decompress.c:102-123) is ``(i*step) & mask`` for i = 0..tableSize-1, a
fixed permutation (step is odd); skipping the cells above highThreshold is
"drop the positions that land in the low-probability region, keeping
order".  So the spread is: generate the permutation, mask, rank by a
prefix sum and scatter, over [B, 2^max_table_log] at once.

Translations of the JAX ops: ``argsort(stable=True)`` is
``torch.sort(stable=True)``, ``searchsorted(side="right")`` is
``torch.searchsorted(right=True)``, ``lax.clz`` the exact integer
``bitio.highbit``, and ``.at[].set(mode="drop")`` a scatter into one spare
column that is cut off.  Gathers clamp their indices, as XLA's do.  The
arithmetic runs in int64 and the outputs wrap to int32 as the originals'.

Inputs are padded per block: norm[B, nsym] (int32, -1 = low-probability),
table_log[B]; tables are padded to the max table size.
"""
from __future__ import annotations

import torch

from ..config import FSE_MAX_SYMBOL_VALUE
from .bitio import highbit, to_i32


def _scatter_drop(B: int, size: int, pos: torch.Tensor, vals: torch.Tensor,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """out[b, pos[b, i]] = vals[b, i] for 0 <= pos < size; other positions
    are dropped (JAX's mode="drop").  out: [B, size + 1] (the spare column
    takes the drops), zeros when None."""
    if out is None:
        out = torch.zeros((B, size + 1), dtype=torch.int64, device=pos.device)
    pos = torch.where((pos >= 0) & (pos < size), pos, size)
    return out.scatter_(1, pos, vals.to(torch.int64).expand_as(pos).contiguous())


def _spread_cells(norm: torch.Tensor, tl: torch.Tensor, max_table_log: int):
    """Which symbol occupies each state cell: [B, 2^max_table_log] int64 (the
    spare column still attached), 0 beyond the live table."""
    B, nsym = norm.shape
    dev = norm.device
    max_size = 1 << max_table_log
    table_size = 1 << tl                              # [B, 1]
    mask = table_size - 1
    step = (table_size >> 1) + (table_size >> 3) + 3
    cell = torch.arange(max_size, device=dev)[None, :]
    live = cell < table_size

    n_low = (norm == -1).sum(dim=1, keepdim=True)
    high_threshold = table_size - 1 - n_low

    # positive-count symbols, assigned to the filtered spread sequence
    cum = torch.cumsum(norm.clamp(min=0), dim=1)      # total of symbols <= s
    seq = (cell * step) & mask                        # visit order
    valid = live & (seq <= high_threshold)
    rank = torch.cumsum(valid.to(torch.int64), dim=1) - 1
    sym_of_rank = torch.searchsorted(cum.contiguous(), rank.contiguous(), right=True)
    out = _scatter_drop(B, max_size, torch.where(valid, seq, max_size), sym_of_rank)

    # low-probability symbols occupy the top cells in increasing-symbol,
    # decreasing-cell order
    is_low = norm == -1
    low_rank = torch.cumsum(is_low.to(torch.int64), dim=1) - 1
    low_cell = torch.where(is_low, table_size - 1 - low_rank, max_size)
    syms = torch.arange(nsym, device=dev)[None, :]
    out = _scatter_drop(B, max_size, low_cell, syms, out)
    return out[:, :max_size]


def _occurrence_rank(symbol_of_cell: torch.Tensor) -> torch.Tensor:
    """Occurrence index of each cell within its symbol group, by cell order:
    a stable sort by symbol groups the cells in (symbol, cell) order, and
    position minus group start is the rank."""
    B, max_size = symbol_of_cell.shape
    sym_sorted, order = torch.sort(symbol_of_cell, dim=1, stable=True)
    idx = torch.arange(max_size, device=symbol_of_cell.device)[None, :]
    first_of_sym = torch.searchsorted(sym_sorted, sym_sorted, right=False)
    rank = torch.zeros_like(symbol_of_cell)
    return rank.scatter_(1, order, idx - first_of_sym)


def _prep(norm, table_log, max_table_log):
    norm = norm.to(torch.int64)
    tl = table_log.to(torch.int64)[:, None]
    soc = _spread_cells(norm, tl, max_table_log)
    occ = _occurrence_rank(soc)
    # the per-symbol gathers clamp, as XLA's gather does
    soc_idx = soc.clamp(0, norm.shape[1] - 1)
    return norm, tl, soc, occ, soc_idx


def build_dtables(norm: torch.Tensor, table_log: torch.Tensor,
                  max_table_log: int = 12,
                  num_symbols: int = FSE_MAX_SYMBOL_VALUE + 1):
    """norm[B, nsym], table_log[B] -> batched decode tables: (new_state,
    symbol, nb_bits) [B, 2^max_table_log] int32, fast_mode[B] bool."""
    norm, tl, soc, occ, soc_idx = _prep(norm, table_log, max_table_log)
    max_size = 1 << max_table_log
    table_size = 1 << tl
    # the reference's symbolNext starts at norm[s] (1 for low-probability
    # symbols) and counts up per cell in cell order
    base = torch.where(norm == -1, 1, norm)
    next_state = torch.gather(base, 1, soc_idx) + occ
    nb_bits = tl - highbit(next_state & 0xFFFFFFFF)
    new_state = (next_state << nb_bits.clamp(min=0)) - table_size

    live = torch.arange(max_size, device=norm.device)[None, :] < table_size
    nb_bits = torch.where(live, nb_bits, 0)
    new_state = torch.where(live, new_state, 0)
    symbol = torch.where(live, soc, 0)

    large_limit = 1 << (tl - 1).clamp(min=0)
    fast_mode = ~((norm >= large_limit) & (norm != -1)).any(dim=1)
    return to_i32(new_state), to_i32(symbol), to_i32(nb_bits), fast_mode


def build_ctables(norm: torch.Tensor, table_log: torch.Tensor,
                  max_table_log: int = 12,
                  num_symbols: int = FSE_MAX_SYMBOL_VALUE + 1):
    """norm[B, nsym], table_log[B] -> batched encode tables:
    state_table[B, 2^max_table_log] (the next-state value per (symbol,
    occurrence) slot in symbol-major order, the reference's tableU16) and
    the per-symbol transform delta_find_state[B, nsym], delta_nb_bits[B,
    nsym] (fse_compress.c:130-154), all int32."""
    norm, tl, soc, occ, soc_idx = _prep(norm, table_log, max_table_log)
    B = norm.shape[0]
    max_size = 1 << max_table_log
    table_size = 1 << tl

    # slots per symbol (1 for low-probability), cumulative start offsets
    slots = torch.where(norm == -1, 1, norm.clamp(min=0))
    cumul = torch.cumsum(slots, dim=1) - slots
    cell = torch.arange(max_size, device=norm.device)[None, :]
    slot = torch.gather(cumul, 1, soc_idx) + occ
    live = cell < table_size
    state_table = _scatter_drop(B, max_size, torch.where(live, slot, max_size),
                                torch.where(live, table_size + cell, 0))[:, :max_size]

    n = norm.clamp(min=0)
    total = cumul          # the running "total" of the reference build
    hb = torch.where(n > 1, highbit((n - 1).clamp(min=1)), 0)
    max_bits_out = tl - hb
    min_state_plus = n << max_bits_out.clamp(min=0)
    dnb_default = (max_bits_out << 16) - min_state_plus
    dfs_default = total - n
    is_one = (norm == -1) | (norm == 1)
    dnb = torch.where(norm == 0, ((tl + 1) << 16) - table_size,
                      torch.where(is_one, (tl << 16) - table_size, dnb_default))
    dfs = torch.where(norm == 0, 0, torch.where(is_one, total - 1, dfs_default))
    return to_i32(state_table), to_i32(dfs), to_i32(dnb)
