"""The share of the traced epochs' host-clock time in which the device was
idle while the host was inside a training entry (``qbmx.train``) but outside
its steps, validation and sampler calls: uploads, the loss fetch, host
metrics and bookkeeping of the epoch loop (benchmark/spans.py)."""

from benchmark import spans


def read(m):
    return spans.idle_pct(m.trace, "epoch")
