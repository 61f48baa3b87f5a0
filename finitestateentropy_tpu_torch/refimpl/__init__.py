"""Reference-exact host code: histogram, normalization, NCount, the FSE
tables (the v0 TurboFSE codec builds them), the bitstream, and the host
twins of the compat codecs (fse.py, huf.py, zlibh.py, with blocktypes.py).

Copies of the JAX package's refimpl modules of the same names; the tests
hold each equal to its original.
"""
