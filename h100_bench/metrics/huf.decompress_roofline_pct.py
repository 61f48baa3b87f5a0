"""The Huff0 decompress calls' bytes (frame read once, output written
once) at the peak memory bandwidth, as a share of the device time of every
kernel that ran inside them: the X1 decode (csrc/huf_decode.cu) and the X1
table build's torch ops (ops/huf_kernels.build_dtables_x1)."""
from h100_bench.readers import roofline_pct


def read(rec):
    return roofline_pct(rec, "decompress")
