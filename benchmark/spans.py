"""The program's own spans in a traced run: the ``qbmx.*`` host ranges
that ``qbmx_torch/utils/spans.py`` opens while a profiler runs, read from
``Trace.host_ops`` beside ``Trace.device_ops`` (one clock, the profiler's).

The device's idle time inside the program is the part of the union of
the ``qbmx.train`` spans (a call of a training entry) in which no device
operation ran.  Each idle instant is charged to the innermost layer the
host was in: ``qbmx.sampler`` (a sampler call), else ``qbmx.step`` or
``qbmx.validate``, else the epoch loop (uploads, the loss fetch, host
metrics, bookkeeping).  The four shares add up to the idle time inside
``qbmx.train``; the rest of ``device_idle_pct`` is the harness's glue
between calls.  A trace of a program without these spans (no
``qbmx.train``) gives ``None`` for every reading."""

from __future__ import annotations

from benchmark.trace import union_us

TRAIN, STEP, VALIDATE, SAMPLER = "qbmx.train", "qbmx.step", "qbmx.validate", "qbmx.sampler"
SYNC = "qbmx.sync."


def merge(intervals) -> list:
    """(start, end) intervals as sorted disjoint ones covering the same time."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return [(s, e) for s, e in out]


def intersect(a: list, b: list) -> list:
    """The time both merged lists cover."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(a: list, b: list) -> list:
    """The time merged list ``a`` covers and merged list ``b`` does not."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > s:
                out.append((s, b[k][0]))
            s = max(s, b[k][1])
            k += 1
        if s < e:
            out.append((s, e))
    return out


def spans(trace, name: str) -> list:
    """The merged host intervals of the spans named exactly ``name``."""
    return merge((s, e) for n, s, e in trace.host_ops if n == name)


def traced(trace) -> bool:
    """Whether the traced program opened its spans at all."""
    return trace is not None and any(n == TRAIN for n, _, _ in trace.host_ops)


def idle_split(trace) -> dict | None:
    """µs of device idle time inside ``qbmx.train`` charged to each layer,
    innermost first: ``{"sampler", "step", "validate", "epoch"}``;
    ``None`` without the spans."""
    if not traced(trace):
        return None
    busy = merge((s, e) for _, s, e in trace.device_ops)
    idle = subtract(spans(trace, TRAIN), busy)
    out = {}
    for layer, name in (("sampler", SAMPLER), ("step", STEP), ("validate", VALIDATE)):
        inside = spans(trace, name)
        out[layer] = union_us(intersect(idle, inside))
        idle = subtract(idle, inside)
    out["epoch"] = union_us(idle)
    return out


def idle_pct(trace, layer: str) -> float | None:
    """``layer``'s device idle time as a share of the traced window, in %."""
    split = idle_split(trace)
    return None if split is None else 100.0 * split[layer] / (1e6 * trace.window_s)


def sync_count(trace) -> int | None:
    """The ``qbmx.sync.*`` spans of the traced epochs: the blocking
    host-device calls.  A span is counted whether or not the queue it
    drains still held work (one that follows another sync waits on an
    empty queue), and on the CPU, where nothing waits."""
    if not traced(trace):
        return None
    return sum(1 for n, _, _ in trace.host_ops if n.startswith(SYNC))
