"""Program spans: named host ranges that torch.profiler records.

Every span of the port goes through span(name).  With no profiler
collecting, it returns one shared no-op context and never enters
torch.profiler.record_function, whose bookkeeping costs microseconds a
call even when nothing records it.  Under torch.profiler (or any other
profiler that records record_function ranges) it is record_function(name).
There is no switch of its own: run torch.profiler around the calls.

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        turbo_compress_device(data)
    p.export_chrome_trace("trace.json")   # turbo.compress > turbo.c_prep > ...
"""
from __future__ import annotations

from contextlib import nullcontext

import torch
from torch.profiler import record_function

_OFF = nullcontext()
# whether a profiler collects on the calling thread
collecting = torch._C._autograd._profiler_enabled


def span(name: str):
    """A context manager that marks the enclosed host work as `name` in a
    profiler's trace, and does nothing when no profiler is collecting.

    Spans share the device trace's clock: in a torch.profiler trace with
    CUDA activity, the kernels and copies a span launched lie on the same
    microsecond axis.  Nesting on the calling thread is the parent link: an
    entry point's span (turbo.compress, resident.decompress, ...) holds all
    the spans of that call.  A span opened on another thread is recorded
    only if that thread carries the profiler's thread-local state: the
    workers of turbo/api.py's _map enter the caller's state for each item
    (utils/profiler_tls.py), so their spans lie on the workers' own tids
    inside the caller's stage span.  Where that library cannot be built or
    loaded, and on any thread of the program's own that enters no state,
    only the calling thread's work is named."""
    return record_function(name) if collecting() else _OFF
