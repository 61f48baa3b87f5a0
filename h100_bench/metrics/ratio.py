"""Original bytes over frame bytes, summed over the window's compress calls."""
from h100_bench.readers import calls


def read(rec):
    cs = [c for c in calls(rec, "compress") if c.ok]
    framed = sum(c.n_out for c in cs)
    return sum(rec.sizes[c.buf] for c in cs) / framed if framed else None
