"""Host time of the Huff0 decompress under its transfers per MiB of output:
"huf.d_h2d" (the stream rows, sizes, weights and tableLogs uploaded) and
"huf.d_d2h" (the pull of the error flags and the decoded rows, in which
the host waits for the X1 decode to finish)."""
from h100_bench.readers import span_ms_per_mib


def read(rec):
    return span_ms_per_mib(rec, "decompress", ("huf.d_h2d", "huf.d_d2h"))
