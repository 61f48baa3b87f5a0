"""Decompress rate: original bytes over the decompress calls' wall time,
GB/s."""
from h100_bench.readers import rate_gbps


def read(rec):
    return rate_gbps(rec, "decompress")
