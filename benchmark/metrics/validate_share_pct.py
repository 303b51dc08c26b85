"""The share of the traced epochs' host-clock time spent in validation:
the union of the program's ``qbmx.validate`` spans (the validation inside
a training entry, its host metrics included) over the traced time."""

from benchmark import spans


def read(m):
    t = m.trace
    if not spans.traced(t):
        return None
    return 100.0 * spans.union_us(spans.spans(t, spans.VALIDATE)) / (1e6 * t.window_s)
