"""Host time of the compat compress outside the checksum and the device:
the FSE codec's "fse.c_prep" (histograms, normalization, NCount headers),
"fse.c_stage" (the padded batch) and "fse.c_frames" (block payloads) spans
and the frame layer's "frame.c_write" (descriptors, the payloads joined)
per MiB of input."""
from h100_bench.readers import span_ms_per_mib


def read(rec):
    return span_ms_per_mib(rec, "compress", ("fse.c_prep", "fse.c_stage",
                                             "fse.c_frames", "frame.c_write"))
