"""Device ops, batched over groups or blocks.

The resident TurboRANS pipeline's ops, XLA ops outside any Pallas kernel
in the JAX package, are PyTorch ops on the tensors' device here: the
histogram (hist.py), the count normalization (norm.py, bit-identical to
refimpl/norm.py) and the encode and decode table builds (rans_tables.py).
Each takes a batch of groups, [G, ...], and syncs nothing to the host.

The compat codecs' ops: bit I/O (bitio.py) and the FSE table build
(fse_tables.py) as torch ops, and the wrappers of the five compat CUDA
kernels with their plain versions (fse_kernels.py, huf_kernels.py, which
also builds the Huff0 X1 tables).
"""
