"""Host time of io.frame.decompress_bytes under its "frame.d_checksum"
spans (the XXH32 of the output, held against the trailer) per MiB of
output."""
from h100_bench.readers import span_ms_per_mib


def read(rec):
    return span_ms_per_mib(rec, "decompress", ("frame.d_checksum",))
