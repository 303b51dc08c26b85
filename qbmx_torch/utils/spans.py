"""Named host ranges at the port's layer boundaries, for ``torch.profiler``.

``span(name)`` opens ``torch.profiler.record_function("qbmx." + name)``
while a profiler runs, and otherwise returns one shared context manager
that does nothing: no allocation, no device operation, no sync (an
idle ``record_function`` would still enter the dispatcher, microseconds
a range; the check is one C call).  The ranges land in the profiler's host events beside
the device operations, on its clock, so a trace tells which layer's host
work each gap in the device's timeline falls in.  A range counts once
each time it is opened: the number of ``qbmx.sync.*`` ranges in a trace
is the number of blocking host-device calls, whether or not the device
still had work queued when each was made.

The names, one per layer boundary (PERF.md §3 lists the sites):

* ``train``: a call of a training entry (``train.loop.train_model``,
  ``train.sweep._SeedSweep.train``), set-up and uploads included;
* ``epoch``: one epoch of those loops, its metrics and bookkeeping included;
* ``step``: a model's or sweep's ``_step``;
* ``validate``: the validation inside a training entry, its host metrics
  included; inside it ``predict`` (a model's ``predict_batch``, a sweep's
  ``_validate``);
* ``sampler``: a call of ``samplers.api.sampler_sample_groups``, the
  sampler layer's one entry; inside it ``sampler.wrapper`` (the SA, BMS or
  PT sampler's own call: its kernel wrapper), in that ``row_lists`` (J_g's
  row lists for K4 and K5) and ``sampler.launch`` (the kernel's launch);
* ``sync.<site>``: one blocking host-device call (a fetch, a host→device
  copy from pageable memory, ``nonzero``).
"""

from __future__ import annotations

import contextlib
import functools

import torch

PREFIX = "qbmx."

_IDLE = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled


def span(name: str):
    """A ``qbmx.<name>`` range while a profiler runs; else a shared no-op."""
    if not _profiling():
        return _IDLE
    return torch.profiler.record_function(PREFIX + name)


def spanned(name: str):
    """Decorator: the function runs inside ``span(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap
