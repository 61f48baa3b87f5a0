"""Share of the compress calls' wall time with no kernel, copy or memset on
the device."""
from h100_bench.readers import idle_pct


def read(rec):
    return idle_pct(rec, "compress")
