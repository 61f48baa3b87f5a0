"""The CPU share of the pool items' wall time: 100 x cpu / wall of the
program's counter turbo/api.py pool_seconds, which sums, for the _map calls
made under the profiler (the traced window), each item's wall and thread
CPU seconds on the thread that ran it.  A low share is items waiting (on
the GIL, or for a core), not working.  Read from the loaded module, never
imported; None when the module or its counter is absent, or nothing ran."""
import sys


def read(rec):
    api = sys.modules.get("finitestateentropy_tpu_torch.turbo.api")
    counts = getattr(api, "pool_seconds", None)
    if not counts or not counts.get("wall"):
        return None
    return 100.0 * counts["cpu"] / counts["wall"]
