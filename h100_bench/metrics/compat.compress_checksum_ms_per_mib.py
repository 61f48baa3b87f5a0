"""Host time of io.frame.compress_bytes under its "frame.c_checksum" spans
(the XXH32 of the input and the trailer) per MiB of input."""
from h100_bench.readers import span_ms_per_mib


def read(rec):
    return span_ms_per_mib(rec, "compress", ("frame.c_checksum",))
