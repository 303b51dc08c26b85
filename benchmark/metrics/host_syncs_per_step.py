"""The blocking host-device calls (the program's ``qbmx.sync.*`` spans:
fetches, host-to-device copies from pageable memory, ``nonzero``) over the
traced epochs, per training step; validation's and the epoch loop's with
them, as ``device_ops_per_step`` counts its operations.  A call counts
whether or not the device still had work queued when it was made."""

from benchmark import spans


def read(m):
    t = m.trace
    n = spans.sync_count(t)
    return n / t.steps if n is not None and t.steps else None
