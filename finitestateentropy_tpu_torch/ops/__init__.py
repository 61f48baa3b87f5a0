"""Device ops of the resident TurboRANS pipeline, batched over groups.

The JAX package runs these as XLA ops outside any Pallas kernel; here they
are PyTorch ops on the tensors' device: the histogram (hist.py), the
count normalization (norm.py, bit-identical to refimpl/norm.py) and the
encode and decode table builds (rans_tables.py).  Each takes a batch of
groups, [G, ...], and syncs nothing to the host.
"""
