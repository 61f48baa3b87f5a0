"""Reference-exact host code: histogram, normalization, NCount and the FSE
tables (the v0 TurboFSE codec builds them).

Copies of the JAX package's refimpl modules of the same names; the tests
hold each equal to its original.
"""
