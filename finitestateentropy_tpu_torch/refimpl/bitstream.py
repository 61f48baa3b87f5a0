"""Bit helpers of the reference's lib/bitstream.h that the port's host code
needs (the JAX package's refimpl/bitstream.py holds the full LIFO stream)."""
from __future__ import annotations


def highbit32(v: int) -> int:
    """Index of the highest set bit (v != 0)."""
    return v.bit_length() - 1
