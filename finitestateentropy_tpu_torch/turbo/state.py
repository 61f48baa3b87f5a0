"""Per-group coder state carried from the JAX layouts onto the port's tensors.

The codec has no learned weights.  What crosses between the packages is
the per-group state the JAX kernel wrappers take as numpy arrays: packed
encode tables and magic reciprocals, decode tables, init states, packed
stream words, shipped step counts and stream sizes.  ``to_tensors`` turns
those arrays, in the JAX wrappers' layouts and argument names, into
tensors on one device that the port's wrappers of the same names accept,
so both packages run on identical inputs.
"""
from __future__ import annotations

import numpy as np
import torch

# argument name -> the ranks it may have, as the JAX wrappers (and the
# port's) take them.  tch = max(2^tlog / 128, 1); spc = steps per word: 4
# byte, 2 pair / u16 / u16x, 1 quad; t4 = supercycles, T = spc * t4 steps.
LAYOUTS = {
    "fc_tables": (3,),     # [G, nch, 128]  (cumul << 12) | freq: nch 2 (256
                           #   symbols / ids), 8 (u16, 1024 symbols), or 32
                           #   (u16x, 4096 symbols, (cumul << 14) | freq)
    "magic_tables": (3,),  # [G, nch, 128]  floor(2^32 / freq), clipped
    "src_words": (3,),     # [G, t4*8, 128]  4 bytes (byte), 2 u16 pair ids
                           #   or u16 symbols (pair, u16, u16x) or 1 quad id
                           #   (quad) per word
    "csize_hw": (1,),      # [G]  stream halfwords
    "csize_bits": (1,),    # [G]  v0 stream bits (turbo/kernels.py)
    "tables": (3,),        # byte: [G, tch, 128]  (cumul << 20) | (freq << 8) | sym
                           # v0: [G, 16, 128]  (base << 16) | (nb << 8) | sym
                           # pair, quad: [G, tch+2, 128]  (id << 2*tlog) |
                           #   (freq << tlog) | (slot - cumul), then the
                           #   256-entry id LUT (u16 pair / u32 quad values)
                           # u16: [G, tch, 128]  (cumul << 21) | (freq << 10) | sym
                           # u16x: [G, 2*tch, 128]  (freq << 13) | (slot -
                           #   cumul), then the symbol of each slot
    "init_states": (3,),   # [G, 8, 128]  decoder initial states
    "streams": (3,),       # [G, srows, 128]  packed payload words (v0:
                           #   [G, wrows, 128] u32 bit-stream words)
    "steptots": (2, 3),    # [G, T, 8]  per-step per-row renorm counts
                           #   (FLAG_STEPTOTS), or [G, T] per-step totals
                           #   (FLAG_TOTALS)
}


def resolve_device(device=None) -> torch.device:
    """The entry points' device: ``cuda`` unless the caller names another.
    Raises when CUDA is asked for and absent — never a silent CPU run."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels")
    return dev


def to_tensors(device=None, **arrays) -> dict[str, torch.Tensor]:
    """numpy arrays named as in LAYOUTS -> int32 tensors on ``device``.

    u32 arrays are reinterpreted as i32 bit patterns (the kernels' native
    type); other integer arrays must fit int32 and are converted."""
    dev = resolve_device(device)
    out = {}
    for name, a in arrays.items():
        if name not in LAYOUTS:
            raise KeyError(f"unknown state array {name!r}; expected one of "
                           f"{sorted(LAYOUTS)}")
        a = np.asarray(a)
        if a.ndim not in LAYOUTS[name]:
            raise ValueError(f"{name}: expected rank in {LAYOUTS[name]}, "
                             f"got shape {a.shape}")
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        elif a.dtype != np.int32:
            if a.dtype.kind not in "iu" or (a.size and (
                    a.min() < np.iinfo(np.int32).min
                    or a.max() > np.iinfo(np.int32).max)):
                raise ValueError(f"{name}: {a.dtype} values do not fit int32")
            a = a.astype(np.int32)
        out[name] = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return out
