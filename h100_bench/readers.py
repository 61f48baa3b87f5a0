"""Arithmetic that the metric readers (metrics/<name>.py) share.

Each reader is `read(rec) -> float | None`, where rec is the run's Record
(harness.py): the window's calls on the host clock, the set-up time, and
in a traced run the trace and the program's stage seconds.  A reader that
finds nothing to read returns None, and the metric is left out.
"""
from __future__ import annotations

MiB = 1 << 20


def calls(rec, kind: str) -> list:
    return [c for c in rec.calls if c.kind == kind]


def rate_gbps(rec, kind: str) -> float | None:
    """Original bytes of the calls of `kind` that succeeded over the sum of
    all those calls' wall times, in GB/s (1e9 bytes)."""
    cs = calls(rec, kind)
    wall = sum(c.t1 - c.t0 for c in cs)
    if not cs or wall <= 0:
        return None
    return sum(rec.sizes[c.buf] for c in cs if c.ok) / wall / 1e9


def input_mib(rec, kind: str) -> float:
    """MiB of original data that the calls of `kind` carried."""
    return sum(rec.sizes[c.buf] for c in calls(rec, kind) if c.ok) / MiB


def stage_ms_per_mib(rec, kind: str, stages: tuple) -> float | None:
    """The program's stage seconds (summed over the window) per MiB."""
    if not rec.stages or not any(s in rec.stages for s in stages):
        return None
    mib = input_mib(rec, kind)
    return sum(rec.stages.get(s, 0.0) for s in stages) * 1e3 / mib if mib else None


def span_ms_per_mib(rec, kind: str, names: tuple) -> float | None:
    """Host time under the program's marked ranges `names` per MiB."""
    if rec.trace is None:
        return None
    us = sum(e - s for n in names for s, e in rec.trace.intervals(n))
    mib = input_mib(rec, kind)
    return us / 1e3 / mib if us and mib else None


def roofline_pct(rec, kind: str) -> float | None:
    """The least time the calls' bytes need at the peak memory bandwidth
    (rec.work.call_bytes: each byte read once, each written once) as a
    share of the device time of every kernel that ran inside the calls."""
    if rec.trace is None or not rec.peak_bytes_per_s:
        return None
    kernel_s = rec.trace.kernel_us(rec.trace.intervals("bench." + kind)) / 1e6
    if kernel_s <= 0:
        return None
    nbytes = sum(rec.work.call_bytes(c) for c in calls(rec, kind) if c.ok)
    return 100.0 * nbytes / rec.peak_bytes_per_s / kernel_s


def idle_pct(rec, kind: str) -> float | None:
    """Share of the calls' wall time (the trace's) in which the device ran
    no kernel, copy or memset."""
    if rec.trace is None or not rec.trace.device_ops:
        return None
    iv = rec.trace.intervals("bench." + kind)
    wall = sum(e - s for s, e in iv)
    if wall <= 0:
        return None
    return 100.0 * (1.0 - rec.trace.busy_us(iv) / wall)
