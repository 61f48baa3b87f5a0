"""Host time of turbo_compress_device's byte-wire stats under the
"turbo.prep.byte" spans (prep_group: histogram, normalization, NCount)
per MiB of input.  Only groups prepped on the calling thread are seen."""
from h100_bench.readers import span_ms_per_mib


def read(rec):
    return span_ms_per_mib(rec, "compress", ("turbo.prep.byte",))
