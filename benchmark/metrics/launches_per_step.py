"""The port's kernel launches (its own counters, samplers/launches.py)
over the window, per sampler call: a training step or a validation chunk
each make one call."""


def read(m):
    return sum(m.launches.values()) / m.sampler_calls if m.sampler_calls else None
