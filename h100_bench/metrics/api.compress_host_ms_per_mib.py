"""Host stages of turbo_compress_device (stage_seconds c_prep + c_stage +
c_frames) per MiB of input."""
from h100_bench.readers import stage_ms_per_mib


def read(rec):
    return stage_ms_per_mib(rec, "compress", ("c_prep", "c_stage", "c_frames"))
