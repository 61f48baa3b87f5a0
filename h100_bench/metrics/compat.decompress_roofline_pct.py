"""The compat decompress calls' bytes (frame read once, output written
once) at the peak memory bandwidth, as a share of the device time of every
kernel that ran inside them: the FSE decode (csrc/fse_decode.cu) and the
table builds' torch ops (ops/fse_tables.py)."""
from h100_bench.readers import roofline_pct


def read(rec):
    return roofline_pct(rec, "decompress")
