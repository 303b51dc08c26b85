"""Seconds from the start of the process to the first timed epoch:
imports, inputs and weights, the model, the kernels' build or load, the
warm-up epoch and its recording."""


def read(m):
    return m.setup_s
