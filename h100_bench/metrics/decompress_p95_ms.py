"""95th percentile of the decompress calls' wall times over the window, ms."""
import numpy as np

from h100_bench.readers import calls


def read(rec):
    ms = [(c.t1 - c.t0) * 1e3 for c in calls(rec, "decompress")]
    return float(np.percentile(ms, 95)) if ms else None
