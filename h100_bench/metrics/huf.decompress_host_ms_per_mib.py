"""Host time of the Huff0 decompress outside the checksum and the device:
the frame layer's "frame.d_read" (header and block walk) and
"frame.d_write" (blocks, raw and RLE runs joined) spans and the Huff0
codec's "huf.d_parse" (weight headers, jump tables, the padded stream
rows) and "huf.d_out" (the blocks' bytes) per MiB of output."""
from h100_bench.readers import span_ms_per_mib


def read(rec):
    return span_ms_per_mib(rec, "decompress", ("frame.d_read", "huf.d_parse",
                                               "huf.d_out", "frame.d_write"))
