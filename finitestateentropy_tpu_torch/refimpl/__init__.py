"""Reference-exact host code: histogram, normalization and NCount.

Copies of the JAX package's refimpl modules of the same names; the tests
hold each equal to its original.
"""
