"""Host time of rans_compress_resident under its "resident.d2h" and
"resident.frames" marks (the pull of the header stats and words, and the
frames written on the host) per MiB of input."""
from h100_bench.readers import span_ms_per_mib


def read(rec):
    return span_ms_per_mib(rec, "compress", ("resident.d2h", "resident.frames"))
