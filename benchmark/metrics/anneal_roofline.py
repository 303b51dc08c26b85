"""The least time of the traced epochs' anneal calls (benchmark/bound.py,
counted from the configuration's sizes) over the device time of the
port's kernels in them: the kernels' share of their roofline."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "benchmark_metric_kernel_share_pct", Path(__file__).with_name("kernel_share_pct.py"))
_share = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_share)


def read(m):
    t = m.trace
    if t is None:
        return None
    s = _share.kernel_seconds(t)
    return 100.0 * t.bound_s / s if s > 0 else None
