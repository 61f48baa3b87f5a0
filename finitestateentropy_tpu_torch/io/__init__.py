"""Host-side I/O: the compat codecs' frame layer (frame.py, the reference's
.fse frames) and resumable TurboRANS compression (jobs.py).
"""
from .frame import compress_file, decompress_file, compress_bytes, decompress_bytes
