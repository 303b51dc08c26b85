"""The share of the traced epochs' host-clock time in which no operation
ran on the device: 1 - union of the device intervals / the traced time."""


def read(m):
    t = m.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t is not None else None
