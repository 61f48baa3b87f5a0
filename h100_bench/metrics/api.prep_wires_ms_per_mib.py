"""Host time of turbo_compress_device's pair and quad preps and the wire
pick under the "turbo.prep.pair", "turbo.prep.quad" and "turbo.prep.pick"
spans per MiB of input.  Only groups prepped on the calling thread are
seen."""
from h100_bench.readers import span_ms_per_mib


def read(rec):
    return span_ms_per_mib(rec, "compress", ("turbo.prep.pair", "turbo.prep.quad",
                                             "turbo.prep.pick"))
