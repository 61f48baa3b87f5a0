"""The compress calls' bytes (input read once, frame written once) at the
peak memory bandwidth, as a share of the device time of every kernel that
ran inside them."""
from h100_bench.readers import roofline_pct


def read(rec):
    return roofline_pct(rec, "compress")
