"""The median, over every training step of the window, of the CUDA-event
time from the step's first to its last enqueued operation."""

import numpy as np


def read(m):
    return float(np.median(m.step_ms)) if m.step_ms else None
