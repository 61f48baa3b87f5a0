"""Host time of turbo_compress_device's pool items per MiB of input: the
summed durations of every "turbo.pool.prep" span (plan_encode's prep of
one group) and "turbo.pool.stage" span (_stage_wire_batch's staging of
one group), on whichever thread turbo/api.py's _map ran the item."""
from h100_bench.readers import span_ms_per_mib


def read(rec):
    return span_ms_per_mib(rec, "compress", ("turbo.pool.prep", "turbo.pool.stage"))
