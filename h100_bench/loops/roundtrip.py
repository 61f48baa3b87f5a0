"""A closed loop with one caller: each iteration compresses the next buffer
of the pool, then decompresses the frame it just made.

A call's wall time ends when its output is complete (the system's entry
returns a finished output: host bytes, or a device tensor after the
system synchronises).  Nothing else runs inside the window: every frame is
kept, and the decompressed outputs of the iterations that `keep` selects;
both are judged after the window.
"""
from __future__ import annotations

import sys
import time
import traceback
from contextlib import nullcontext
from typing import NamedTuple


class Call(NamedTuple):
    kind: str          # "compress" or "decompress"
    buf: int           # index of the pool buffer the round trip carries
    t0: float          # perf_counter at the call
    t1: float          # perf_counter when its output was complete
    n_in: int          # bytes the call read (input or frame)
    n_out: int         # bytes the call wrote (frame or output); 0 if it raised
    ok: bool           # False when the call raised


class Window(NamedTuple):
    calls: list        # [Call] in order
    frames: list       # [(buf, frame bytes)] of every compress call
    outputs: list      # [(buf, output)] of the kept decompress calls
    start: float
    end: float


MAX_TRACEBACKS = 3


def _call(fn, arg, errors: list):
    """(result or None, ok) of fn(arg); a raising call is recorded, and the
    loop goes on with the next buffer."""
    try:
        return fn(arg), True
    except Exception:                       # the window must keep running
        if len(errors) < MAX_TRACEBACKS:
            errors.append(traceback.format_exc())
            print(errors[-1], file=sys.stderr)
        return None, False


def warm_up(system, inputs: list) -> None:
    """One round trip before the window: the builds, the first launches and
    allocations (every buffer of a pool has one size)."""
    system.decompress(system.compress(inputs[0]))


def run(system, inputs: list, sizes: list, seconds: float, keep,
        span=None) -> Window:
    """Round trips over the pool until `seconds` have passed (the last one
    started before the end runs whole).  sizes[b] is buffer b's length;
    keep(i) says whether iteration i's output is kept for the check; span
    (a name -> context manager) marks each call for a trace."""
    span = span or (lambda _name: nullcontext())
    calls, frames, outputs, errors = [], [], [], []
    clock = time.perf_counter
    start = clock()
    end = start + seconds
    i = 0
    while True:
        b = i % len(inputs)
        with span("bench.compress"):
            t0 = clock()
            frame, ok = _call(system.compress, inputs[b], errors)
            t1 = clock()
        calls.append(Call("compress", b, t0, t1, sizes[b],
                          len(frame) if ok else 0, ok))
        if ok:
            frames.append((b, frame))
            with span("bench.decompress"):
                t0 = clock()
                out, ok = _call(system.decompress, frame, errors)
                t1 = clock()
            calls.append(Call("decompress", b, t0, t1, len(frame),
                              system.nbytes(out) if ok else 0, ok))
            if ok and keep(i):
                outputs.append((b, out))
            del out
        i += 1
        if t1 >= end:
            return Window(calls, frames, outputs, start, t1)
