"""The least time of every anneal call of the window's epochs, training
and validation (benchmark/bound.py: decisions at the float32 issue rate of
67 TFLOP/s, counted from the configuration's sizes), over the window's
host-clock time: the whole training loop's share of the card's peak."""


def read(m):
    return 100.0 * m.bound_s / m.window_s
