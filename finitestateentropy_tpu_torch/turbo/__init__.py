"""TurboRANS on the GPU: the lane-interleaved rANS codec's byte wire.

rans.py holds the wire and its bit-exact numpy twin, tables.py the table
packers, rans_kernels.py the CUDA kernel wrappers with their plain PyTorch
versions, state.py the carry-across from the JAX layouts, and api.py the
entry points turbo_compress_device / turbo_decompress_device.
"""


def __getattr__(name):  # lazy: importing the package does not import torch
    if name in ("turbo_compress_device", "turbo_decompress_device"):
        from . import api

        return getattr(api, name)
    raise AttributeError(name)
