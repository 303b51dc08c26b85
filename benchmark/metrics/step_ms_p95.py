"""The 95th percentile, over every training step of the window, of the
CUDA-event time from the step's first to its last enqueued operation."""

import numpy as np


def read(m):
    return float(np.percentile(m.step_ms, 95)) if m.step_ms else None
