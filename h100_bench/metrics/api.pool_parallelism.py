"""The mean number of pool items in flight while turbo_compress_device
preps and stages: the summed durations of the "turbo.pool.prep" and
"turbo.pool.stage" spans (one an item, on the thread that ran it) over
those of the calling thread's "turbo.c_prep" and "turbo.c_stage" spans,
which hold them.  At most 1 where a call's items run on the calling thread;
at most the host's cores where they run on _map's pool."""

POOL = ("turbo.pool.prep", "turbo.pool.stage")
STAGES = ("turbo.c_prep", "turbo.c_stage")


def _us(rec, names) -> float:
    return sum(e - s for n in names for s, e in rec.trace.intervals(n))


def read(rec):
    if rec.trace is None:
        return None
    pool, stages = _us(rec, POOL), _us(rec, STAGES)
    return pool / stages if pool and stages else None
