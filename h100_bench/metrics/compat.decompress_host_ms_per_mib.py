"""Host time of the compat decompress outside the checksum and the device:
the frame layer's "frame.d_read" (header and block walk) and
"frame.d_write" (blocks, raw and RLE runs joined) spans and the FSE
codec's "fse.d_parse" (NCount headers, the padded batch) and "fse.d_out"
(the blocks' bytes) per MiB of output."""
from h100_bench.readers import span_ms_per_mib


def read(rec):
    return span_ms_per_mib(rec, "decompress", ("frame.d_read", "fse.d_parse",
                                               "fse.d_out", "frame.d_write"))
