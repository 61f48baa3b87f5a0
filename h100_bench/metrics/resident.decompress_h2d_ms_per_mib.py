"""Host time of rans_decompress_resident under its "resident.d_h2d" spans
(raw groups' bytes, and each batch's tables, stream words and step counts
sent to the device) per MiB of output."""
from h100_bench.readers import span_ms_per_mib


def read(rec):
    return span_ms_per_mib(rec, "decompress", ("resident.d_h2d",))
