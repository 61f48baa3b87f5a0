"""The decompress calls' bytes (frame read once, output written once) at
the peak memory bandwidth, as a share of the device time of the kernels
that start inside the program's decode batches (the span turbo.d_batch)."""
from h100_bench.readers import calls


def read(rec):
    if rec.trace is None or not rec.peak_bytes_per_s:
        return None
    kernel_s = rec.trace.kernel_us(rec.trace.intervals("turbo.d_batch")) / 1e6
    if kernel_s <= 0:
        return None
    nbytes = sum(rec.work.call_bytes(c) for c in calls(rec, "decompress") if c.ok)
    return 100.0 * nbytes / rec.peak_bytes_per_s / kernel_s
