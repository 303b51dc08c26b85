"""The share of the traced epochs' host-clock time in which the device was
idle while the host was inside validation (``qbmx.validate``) but outside its
sampler calls: inputs, chunks, fetches and host metrics (benchmark/spans.py)."""

from benchmark import spans


def read(m):
    return spans.idle_pct(m.trace, "validate")
