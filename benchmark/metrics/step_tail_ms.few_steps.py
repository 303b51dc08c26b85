"""The 95th percentile of the window's step times where the window holds
too few steps for ten beyond it (a tail near the slowest step)."""

import numpy as np


def read(m):
    return float(np.percentile(m.step_ms, 95)) if m.step_ms else None
