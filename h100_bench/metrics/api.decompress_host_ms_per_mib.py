"""Host stages of turbo_decompress_device (stage_seconds d_parse + d_stage
+ d_copy + d_join) per MiB of output."""
from h100_bench.readers import stage_ms_per_mib


def read(rec):
    return stage_ms_per_mib(rec, "decompress",
                            ("d_parse", "d_stage", "d_copy", "d_join"))
