"""The compat compress calls' bytes (input read once, frame written once)
at the peak memory bandwidth, as a share of the device time of every kernel
that ran inside them: the FSE encode (csrc/fse_encode.cu) and the table
builds' torch ops (ops/fse_tables.py)."""
from h100_bench.readers import roofline_pct


def read(rec):
    return roofline_pct(rec, "compress")
