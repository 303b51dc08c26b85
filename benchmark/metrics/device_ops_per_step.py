"""Device operations (kernels, copies, sets) recorded by torch.profiler
over the traced epochs, per training step; validation's count with them."""


def read(m):
    t = m.trace
    return len(t.device_ops) / t.steps if t is not None and t.steps else None
