"""Device time of the kernels that start inside the program's decode
batches (the span turbo.d_batch: a batch's staging, uploads, launch and
the host's wait for its error flags and rows), in ms per MiB of
decompressed output.  In ratio mode these are the flat v1 decode
(csrc/rans_decode_flat.cu) and its small torch ops."""
from h100_bench.readers import input_mib


def read(rec):
    if rec.trace is None:
        return None
    us = rec.trace.kernel_us(rec.trace.intervals("turbo.d_batch"))
    mib = input_mib(rec, "decompress")
    return us / 1e3 / mib if us > 0 and mib else None
