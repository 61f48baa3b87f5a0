"""Debug logging twin of the reference's lib/debug.h/.c.

The reference gates `DEBUGLOG(level, ...)` on a global `g_debuglevel`
(lib/debug.c:44, default 0; messages print to stderr when level <= the
global).  Same contract here; the level can also come from the
FSE_TPU_DEBUGLEVEL environment variable.  Device-side kernels cannot
raise/print, so in-kernel diagnostics surface as error arrays (see
turbo/rans_kernels.py rans_decode* err returns) — this module covers the
host paths.
"""
from __future__ import annotations

import os
import sys

g_debuglevel = int(os.environ.get("FSE_TPU_DEBUGLEVEL", "0") or 0)


def set_debuglevel(level: int) -> None:
    global g_debuglevel
    g_debuglevel = int(level)


def debuglog(level: int, msg: str, *args) -> None:
    """Print to stderr when level <= g_debuglevel (DEBUGLOG, lib/debug.h:99)."""
    if level <= g_debuglevel:
        print(f"DEBUG[{level}]: {msg % args if args else msg}",
              file=sys.stderr, flush=True)
