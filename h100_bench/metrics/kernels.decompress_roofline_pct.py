"""The decompress calls' bytes (frame read once, output written once) at
the peak memory bandwidth, as a share of the device time of every kernel
that ran inside them."""
from h100_bench.readers import roofline_pct


def read(rec):
    return roofline_pct(rec, "decompress")
