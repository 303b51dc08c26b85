"""The traced slice of a run: a few whole epochs under ``torch.profiler``,
read into device intervals, the device's busy time (the union of its
operations' intervals, as the program's ``cli/profile_steps.py`` takes
it; copied here so that the yardstick does not move with the program),
and the breakdown the result line carries: the device operations that
took most time, and the longest idle gaps by what the host was doing."""

from __future__ import annotations

import collections
import dataclasses
import math
import time


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -math.inf
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


@dataclasses.dataclass
class Trace:
    device_ops: list  # (name, start_us, end_us) of every device operation
    host_ops: list  # (name, start_us, end_us) of every host event
    window_s: float  # host clock over the traced epochs, synchronized
    steps: int
    sampler_calls: int
    launches: dict
    bound_s: float  # the least time of the traced epochs' anneal calls

    @property
    def busy_s(self) -> float:
        return union_us((s, e) for _, s, e in self.device_ops) / 1e6

    def device_seconds(self, stems) -> float:
        """Device time of the operations whose names hold one of ``stems``."""
        return sum(e - s for n, s, e in self.device_ops if any(t in n for t in stems)) / 1e6

    def top_ops(self, k: int = 10) -> list:
        by = collections.Counter()
        for n, s, e in self.device_ops:
            by[n] += (e - s) / 1e6
        return [[n, v] for n, v in by.most_common(k)]

    def idle_gaps(self, k: int = 10) -> list:
        """The ``k`` longest gaps between device operations, each named by
        the innermost harness span (``bench.*``) and the innermost host
        event under way when it began."""
        spans = sorted((s, e) for _, s, e in self.device_ops)
        gaps, end = [], None
        for s, e in spans:
            if end is not None and s > end:
                gaps.append((s - end, end))
            end = e if end is None else max(end, e)
        gaps.sort(reverse=True)
        out = []
        for length, at in gaps[:k]:
            live = [(e - s, n) for n, s, e in self.host_ops if s <= at < e]
            bench = min((x for x in live if x[1].startswith("bench.")), default=(0, "-"))[1]
            inner = min(live, default=(0, "idle host"))[1]
            out.append([f"{bench} > {inner}", length / 1e6])
        return out


def profile(run, device) -> tuple[list, list, float]:
    """Run ``run()`` under ``torch.profiler`` (host and device); returns the
    device operations, the host events and the host-clock seconds."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as _profile

    with _profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    dev, host = [], []
    for e in prof.events():
        rec = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type != DeviceType.CUDA:
            host.append(rec)
        elif not (getattr(e, "is_user_annotation", False) or e.name.startswith("bench.")):
            # a span of the harness's, mirrored on the device's timeline, is no operation
            dev.append(rec)
    if not dev:
        raise RuntimeError("torch.profiler recorded no device operations")
    return dev, host, wall
