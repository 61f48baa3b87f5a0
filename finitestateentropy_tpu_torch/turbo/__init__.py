"""TurboRANS on the GPU: the lane-interleaved rANS codec, and the v0
TurboFSE codec.

rans.py holds the byte wire (speed, ratio and totals frames) and its
bit-exact numpy twin, pair.py and quad.py the pair and quad wires and
theirs, rans16.py the TurboRANS-U16 codec for 16-bit symbols and its twin
(and the u16 lane layout the pair wire shares), tables.py the table
packers, rans_kernels.py the CUDA kernel wrappers with their plain PyTorch
versions, state.py the carry-across from the JAX layouts, and api.py the
entry points turbo_compress_device / turbo_decompress_device and
turbo16_compress_device / turbo16_decompress_device (lazy names here, as
are pair_compress / pair_decompress and quad_compress /
quad_decompress).  format.py is the v0 TurboFSE wire (bit-granular tANS)
and its numpy twin, kernels.py its decode kernel's wrapper.
"""
from .format import (TURBO_LANES, TURBO_MAGIC, turbo_fse_compress,
                     turbo_fse_decompress)


def __getattr__(name):  # lazy: importing the package does not import torch
    if name in ("turbo_compress_device", "turbo_decompress_device",
                "turbo16_compress_device", "turbo16_decompress_device"):
        from . import api

        return getattr(api, name)
    if name in ("pair_compress", "pair_decompress"):
        from . import pair

        return getattr(pair, name)
    if name in ("quad_compress", "quad_decompress"):
        from . import quad

        return getattr(quad, name)
    raise AttributeError(name)
