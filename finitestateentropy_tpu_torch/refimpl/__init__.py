"""Reference-exact host code: histogram, normalization, NCount, the FSE
tables (the v0 TurboFSE codec builds them), the bitstream, and the host
twins of the compat codecs (fse.py, huf.py, zlibh.py, with blocktypes.py)
and of the reference's FSE_U16 (fseu16.py).

Copies of the JAX package's refimpl modules of the same names; the tests
hold each equal to its original.
"""

from .blocktypes import BlockResult, Kind
from .fse import fse_compress, fse_decompress
from .huf import huf_compress, huf_decompress
from .fseu16 import fse_compress_u16, fse_decompress_u16
