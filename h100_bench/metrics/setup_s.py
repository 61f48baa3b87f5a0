"""Seconds from the start of the process to the first timed call: imports,
builds of the kernels and native code on a cold checkout, the inputs made
from the seed, the warm-up."""


def read(rec):
    return rec.setup_s
