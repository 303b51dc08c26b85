"""The share of the traced epochs' host-clock time in which the device was
idle while the host was inside a training step (``qbmx.step``) but outside its
sampler call: the QUBO builders, moments and update (benchmark/spans.py)."""

from benchmark import spans


def read(m):
    return spans.idle_pct(m.trace, "step")
