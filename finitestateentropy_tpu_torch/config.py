"""Wire-format constants the port's host code needs.

Copies of the frozen contract in the JAX package's config.py (reference
lib/fse.h:636-683).  Changing any of them breaks byte-compatibility.
"""
from __future__ import annotations

FSE_MAX_MEMORY_USAGE = 14
FSE_DEFAULT_MEMORY_USAGE = 13
FSE_MAX_TABLELOG = FSE_MAX_MEMORY_USAGE - 2          # 12
FSE_DEFAULT_TABLELOG = FSE_DEFAULT_MEMORY_USAGE - 2  # 11
FSE_MIN_TABLELOG = 5
FSE_TABLELOG_ABSOLUTE_MAX = 15
