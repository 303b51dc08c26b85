"""One cell of the benchmark, built from its configuration and traffic
files: the program's objects, the inputs and weights made from the seed,
and the wrappers the harness puts on those objects' instances to time
the steps and record what the first steps and the validation produce.

The wrappers change no program file.  The step wrapper (on the
instance's ``_step``) records a pair of CUDA events around each call while
timing is on; while recording is on, it also keeps the parameters before
and after the step, its mask and its loss.  The sampler proxy (in place
of the instance's ``sampler``) counts the calls and records their QUBOs
and samples; the validation wrapper records the predictions.  A planted
``fault`` (used by the tests and ``benchmark/control.py`` only) breaks
the path underneath: ``unchanged`` (a step that leaves the state as it
was), ``half_batch`` (the second half of each batch masked out),
``altered_samples`` (the sampler's first unit inverted in every read),
``altered_answers`` (the first half of the validation predictions
inverted), ``short_anneal`` (the sampler runs a tenth of its sweeps),
``mask_ignored`` (the padding rows of a partial batch counted as real).
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import time
from typing import Callable

import numpy as np
import torch

FAULTS = ("unchanged", "half_batch", "altered_samples", "altered_answers", "short_anneal",
          "mask_ignored")


@dataclasses.dataclass
class Cell:
    """What a family module builds: ``owner`` has the ``_step`` the
    entry calls once a batch, ``sampler_host`` the ``sampler`` it calls,
    ``predict_host.<predict_name>`` the validation; ``epoch(e, warm)``
    runs epoch e through the users' entry (``warm``: on the warm-up's
    rows); ``params()`` and ``set_params(d)`` read and write the
    parameters as a dict of tensors with a leading seed axis."""

    owner: object
    sampler_host: object
    predict_host: object
    predict_name: str
    epoch: Callable[[int, bool], None]
    params: Callable[[], dict]
    set_params: Callable[[dict], None]
    seeds: int
    images_per_epoch: int


def family(cfg: dict):
    return importlib.import_module(f"benchmark.families.{cfg['family']}")


def reference(cfg: dict):
    return importlib.import_module(f"benchmark.reference.{cfg['reference']}")


def draw_weights(specs, seeds: int, seed: int, device) -> dict:
    """Every parameter U(−1, 1) from a generator on ``device`` seeded with
    ``seed`` (a configuration's ``weights_seed``), in one draw, float32,
    with a leading seed axis; ``upper`` leaves keep their strictly upper
    triangle, ``zeros`` leaves are 0."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    sizes = [seeds * int(np.prod(shape)) for _, shape, _ in specs]
    flat = torch.rand(sum(sizes), generator=g, device=device) * 2.0 - 1.0
    out = {}
    for (name, shape, kind), part in zip(specs, torch.split(flat, sizes)):
        w = part.reshape((seeds,) + tuple(shape))
        if kind == "upper":
            w = torch.triu(w, 1)
        elif kind == "zeros":
            w = torch.zeros_like(w)
        out[name] = w.contiguous()
    return out


def clone(d: dict) -> dict:
    return {k: v.detach().clone() for k, v in d.items()}


class SamplerProxy:
    """Stands in for a program's sampler: forwards every call, counts it,
    and records it while the recorder records.  With the ``short_anneal``
    fault the calls go to a copy of the sampler with a tenth of its
    sweeps."""

    def __init__(self, sampler, rec: "Recorder"):
        self._rec = rec
        if rec.fault == "short_anneal":
            sampler = dataclasses.replace(sampler, num_sweeps=max(1, sampler.num_sweeps // 10))
        self._sampler = sampler

    def __getattr__(self, name):
        return getattr(self._sampler, name)

    def sample_groups(self, generator, Q_shared, h_extra, num_reads):
        with self._rec.span("bench.sampler_call"):
            out = self._sampler.sample_groups(generator, Q_shared, h_extra, num_reads)
        return self._rec.sampled(Q_shared, h_extra, out)


class Recorder:
    """The wrappers' state.  While ``recording``, the steps whose index
    (counted from the first step recorded) is in ``record_steps`` are
    kept, each with its index."""

    def __init__(self, cell: Cell, device, fault: str | None = None,
                 record_steps=(0, 1, 2)):
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self.cell, self.device, self.fault = cell, device, fault
        self.record_steps = frozenset(record_steps)
        self.timing = self.recording = self.spans = False
        self.step_events: list = []
        self.sampler_calls = self.step_count = self.recorded_index = 0
        self.steps: list[dict] = []
        self.val: dict = {"calls": []}
        self._calls: list | None = None
        self._install()

    # -- the wrappers -----------------------------------------------------------

    def _install(self) -> None:
        cell = self.cell
        step = cell.owner._step
        cell.owner._step = lambda *a, **k: self._step(step, *a, **k)
        cell.sampler_host.sampler = SamplerProxy(cell.sampler_host.sampler, self)
        predict = getattr(cell.predict_host, cell.predict_name)
        setattr(cell.predict_host, cell.predict_name, lambda *a, **k: self._predict(predict, *a, **k))

    def span(self, name: str):
        if not self.spans:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def _mark(self):
        if self.device.type == "cuda":
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def _step(self, step, x, y, mask, lr, *rest, **kw):
        self.step_count += 1
        record = False
        if self.recording:
            record = self.recorded_index in self.record_steps
            self.recorded_index += 1
        if record:
            entry = {"index": self.recorded_index - 1, "before": clone(self.cell.params()),
                     "mask": mask.detach().clone(), "lr": float(lr), "calls": []}
            self._calls = entry["calls"]
        if self.fault == "half_batch":
            mask = mask.clone()
            mask[mask.shape[0] // 2:] = 0.0
        elif self.fault == "mask_ignored":
            mask = torch.ones_like(mask)
        before = clone(self.cell.params()) if self.fault == "unchanged" else None
        start = self._mark() if self.timing else None
        with self.span("bench.step"):
            out = step(x, y, mask, lr, *rest, **kw)
        if self.timing:
            self.step_events.append((start, self._mark()))
        if before is not None:
            self.cell.set_params(before)
        if record:
            nll = out[0] if isinstance(out, tuple) else out  # a single model's (nll, err)
            entry["nll"] = nll.detach().reshape(-1).clone()
            entry["after"] = clone(self.cell.params())
            self.steps.append(entry)
            self._calls = None
        return out

    def _predict(self, predict, *a, **k):
        record = self.recording
        if record:
            self.val = {"params": clone(self.cell.params()), "calls": []}
            self._calls = self.val["calls"]
        with self.span("bench.validate"):
            preds, probs = predict(*a, **k)
        if self.fault == "altered_answers":
            preds = np.array(preds, copy=True)
            half = preds.shape[-1] // 2
            preds[..., :half] = 1 - preds[..., :half]
        if record:
            self._calls = None
            self.val["preds"] = np.asarray(preds).reshape(self.cell.seeds, -1)
            self.val["probs"] = np.asarray(probs).reshape(self.cell.seeds, preds.shape[-1], -1)
        return preds, probs

    def sampled(self, Q_shared, h_extra, out):
        self.sampler_calls += 1
        if self.fault == "altered_samples":
            out = out.clone()
            out[..., 0] = 1.0 - out[..., 0]
        if self._calls is not None:
            self._calls.append({"Q": Q_shared.detach().cpu(), "h": h_extra.detach().cpu(),
                                "s": out.detach().to(torch.uint8).cpu()})
        return out

    # -- after the window ---------------------------------------------------------

    def step_ms(self) -> list[float]:
        """Each timed step's time, first to last enqueued operation, in ms."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            return [a.elapsed_time(b) for a, b in self.step_events]
        return [1e3 * (b - a) for a, b in self.step_events]

    def recording_dict(self) -> dict:
        return {"steps": self.steps, "val": self.val}
