"""On-device byte histogram of a batch of groups (reference lib/hist.c).

The JAX package counts on the TPU's matrix unit through a nibble one-hot
product; the GPU counts exactly in integers: each byte adds one to its
group's bin with a scatter-add.  The bins are split 32 ways by position,
so a warp's 32 lanes add to 32 addresses even on a one-symbol group, and
the copies are summed after.  No host sync (torch.bincount would read
the input's maximum back to size its output).
"""
from __future__ import annotations

import torch

_COPIES = 32     # sub-histograms, one per lane of a warp


def hist_count_masked(data_u8: torch.Tensor, max_len: int,
                      lengths: torch.Tensor | None = None) -> torch.Tensor:
    """[G, max_len] uint8 with per-group valid lengths [G] -> [G, 256]
    int32 exact counts.  Bytes at or past lengths[g] are not counted (the
    ragged-group case); lengths None counts every byte."""
    G, n = data_u8.shape
    if n != max_len:
        raise ValueError(f"data has {n} columns, max_len is {max_len}")
    dev = data_u8.device
    pos = torch.arange(n, device=dev)
    key = (torch.arange(G, device=dev)[:, None] * (_COPIES * 256)
           + (pos & (_COPIES - 1)) * 256 + data_u8.to(torch.int64))
    sink = G * _COPIES * 256
    if lengths is not None:
        key = torch.where(pos < lengths.to(torch.int64)[:, None], key, sink)
    bins = torch.zeros(sink + 1, dtype=torch.int32, device=dev)
    bins.scatter_add_(0, key.reshape(-1),
                      torch.ones(1, dtype=torch.int32, device=dev).expand(G * n))
    return bins[:sink].view(G, _COPIES, 256).sum(dim=1, dtype=torch.int32)


def hist_count_batch(data_u8: torch.Tensor) -> torch.Tensor:
    """[G, N] uint8 -> [G, 256] int32 exact counts."""
    return hist_count_masked(data_u8, data_u8.shape[1])
