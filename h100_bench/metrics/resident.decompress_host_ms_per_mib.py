"""Host time of rans_decompress_resident under its "resident.d_parse" and
"resident.d_stage" spans (the headers parsed, the decode inputs staged on
the host) per MiB of output."""
from h100_bench.readers import span_ms_per_mib


def read(rec):
    return span_ms_per_mib(rec, "decompress",
                           ("resident.d_parse", "resident.d_stage"))
