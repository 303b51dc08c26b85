"""The share of the traced epochs' host-clock time in which the device was
idle while the host was inside a sampler call (the program's
``qbmx.sampler`` span: the sampler API, its kernel wrappers and their
host syncs; benchmark/spans.py)."""

from benchmark import spans


def read(m):
    return spans.idle_pct(m.trace, "sampler")
