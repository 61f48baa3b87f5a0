"""Benchmark harnesses mirroring the reference's two tiers:

* blockbench — whole-codec block benchmark (programs/bench.c): ratio + MB/s
  with XXH32 round-trip verification, invoked by the CLI's -b flag.
* fullbench — per-function micro-benchmarks (programs/fullbench.c) with the
  reference's stage numbering, plus the CUDA kernel stages at 200+.
"""
