"""Run one cell of the benchmark of ``qbmx_torch`` (the PyTorch and CUDA
port) once, from the root of a checkout:

    python3 benchmark/run.py --workload flat_h5.sweep10_sa --seed 7 --seconds 10 --trace 0

Set-up builds the cell from its files (``benchmark/registry.py``): the
configuration's images in an order drawn from ``--seed``, its initial
weights (one set a configuration, so that every seed does the same work),
the program's model or seed sweep with seeds from ``--seed``, the
kernels (built once into the checkout's ``build/kernels/``), and one
warm-up epoch through the users' training entry (or the first batches
and validation chunk where the configuration says so), whose first
training steps and validation are recorded for the check.  The window
then runs whole epochs through the same entry, validation included,
until ``--seconds`` have passed.  With ``--trace 1`` a few more epochs
run under ``torch.profiler`` after the window.  Once the window has
closed and the peak memory is read, the program's state is freed and the
reference judges the recording (``benchmark/check.py``).

The last line of standard output is one JSON object: ``correct``,
``attempted`` (training steps in the window), ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer
ones), ``device``, with ``--trace 1`` ``breakdown``, and last ``checks``:
every number the check compared beside its limit, which also end
standard error.  Exits non-zero, printing no result, without enough CUDA
devices, or if ``jax``, ``jaxlib``, ``flax`` or ``qbmx`` is loaded when
the window has closed.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if not __package__:
    # run as a file: import the harness as the package it is, not its
    # modules as top-level ones
    sys.path[0] = str(ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "qbmx")


def process_start() -> float:
    """The wall-clock time this process started (``/proc``; now where that
    cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


T0 = process_start()


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one the benchmark may not load
    (whole names: ``qbmx_torch`` is not ``qbmx``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build(workload_name: str, seed: int, device, fault: str | None = None, shape=None,
          root: Path = ROOT) -> types.SimpleNamespace:
    """A cell's files, inputs, weights and program objects, with the
    harness's wrappers on them.  ``fault`` plants a fault underneath the
    timed path (the tests' and ``benchmark/control.py``'s); ``shape(cfg,
    mix)`` may resize a cell for a run on the CPU (the tests')."""
    from benchmark import cell, check, data as bdata, registry

    bench = registry.load_benchmark(root)
    wl = registry.workload(bench, workload_name)
    cfg, mix = registry.config(bench, root, wl["config"]), registry.mix(wl["traffic"])
    if shape is not None:
        cfg, mix = shape(cfg, mix)
    data = bdata.make(cfg, seed)
    ref = cell.reference(cfg)
    weights = cell.draw_weights(ref.leaf_specs(cfg["model"]), mix["seeds"],
                                cfg["weights_seed"], device)
    c = cell.family(cfg).build(cfg, mix, seed, data, weights, device)
    t = registry.settings(cfg, mix)
    return types.SimpleNamespace(
        bench=bench, wl=wl, cfg=cfg, mix=mix, t=t, data=data, weights=weights, seed=seed,
        device=device, cell=c, rec=cell.Recorder(c, device, fault, check.record_steps(data, t)))


def warm_up(b) -> None:
    """The first epoch (or its warm-up rows), recording the steps the check
    judges and its validation."""
    b.rec.recording = True
    b.cell.epoch(1, True)
    b.rec.recording = False
    _sync(b.device)


def judge(b, recording: dict) -> dict:
    """The check's numbers of ``recording``, once the program's state is
    freed."""
    from benchmark import check, data as bdata

    warm = bdata.splits(b.data, b.t)["warm"]
    return check.Judge(b.cfg, b.mix, b.data, b.weights, b.seed, b.device).numbers(
        recording, warm[2])


def free(b) -> dict:
    """Drop the program's objects; returns the recording."""
    import torch

    recording = b.rec.recording_dict()
    b.cell = b.rec = None
    gc.collect()
    if b.device.type == "cuda":
        torch.cuda.empty_cache()
    return recording


def run_cell(workload_name: str, seed: int, seconds: float, trace: bool, device,
             fault: str | None = None, shape=None, root: Path = ROOT, t0: float | None = None):
    """One run of a cell on ``device``: ``(result dict, check numbers,
    limits)``; ``fault`` and ``shape`` as :func:`build`'s."""
    import torch

    from benchmark import bound, check, registry
    from benchmark.trace import Trace, profile
    from qbmx_torch.samplers import launches

    t0 = T0 if t0 is None else t0
    t_main = time.time()
    b = build(workload_name, seed, device, fault, shape, root)
    t_built = time.time()
    c, rec = b.cell, b.rec
    warm_up(b)
    t_warm = time.time()

    launches.reset()
    rec.sampler_calls = 0
    rec.timing = True
    start = time.perf_counter()
    setup_s = time.time() - t0
    epoch, epochs = 1, 0
    while not epochs or time.perf_counter() - start < seconds:
        epoch += 1
        c.epoch(epoch, False)
        epochs += 1
    _sync(device)
    window_s = time.perf_counter() - start
    rec.timing = False
    epoch_bound = bound.epoch_seconds(b.cfg, b.mix)
    m = types.SimpleNamespace(
        setup_s=setup_s, window_s=window_s, epochs=epochs, images=c.images_per_epoch * epochs,
        step_ms=rec.step_ms(), sampler_calls=rec.sampler_calls, launches=launches.counts(),
        bound_s=epoch_bound * epochs, trace=None)

    breakdown = None
    if trace:
        launches.reset()
        rec.sampler_calls = rec.step_count = 0
        rec.spans = True
        n_epochs = b.mix["trace_epochs"]

        def traced():
            nonlocal epoch
            for _ in range(n_epochs):
                epoch += 1
                with torch.profiler.record_function("bench.epoch"):
                    c.epoch(epoch, False)

        dev_ops, host_ops, wall = profile(traced, device)
        rec.spans = False
        m.trace = Trace(dev_ops, host_ops, wall, rec.step_count, rec.sampler_calls,
                        launches.counts(), epoch_bound * n_epochs)
        breakdown = {"device_ops": m.trace.top_ops(), "idle_gaps": m.trace.idle_gaps()}

    on_card = device.type == "cuda"
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    del c, rec
    t_judge = time.perf_counter()
    numbers = judge(b, free(b))
    print(f"benchmark: window {window_s!r} s over {epochs} epochs, set-up {setup_s!r} s "
          f"(to the cell {t_main - t0:.3f}, its objects {t_built - t_main:.3f}, warm-up "
          f"{t_warm - t_built:.3f}), check {time.perf_counter() - t_judge!r} s", file=sys.stderr)
    limits = registry.limits(workload_name)

    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for entry in registry.metrics_of(b.bench, kind, workload_name):
        value = registry.metric(entry["name"]).read(m)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": b.wl["chips"], "memory_peak_bytes": int(memory_peak)}
    if m.trace is not None:
        dev.update(busy_s=m.trace.busy_s, window_s=m.trace.window_s)
    result = {"correct": check.verdict(numbers, limits), "attempted": len(m.step_ms),
              "failed": 0, "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    return result, numbers, limits


def result_line(result: dict, numbers: dict, limits: dict) -> str:
    """The run's last line: the result with ``checks`` last, every number
    compared beside its limit (a number that is not finite as a string)."""
    checks = {k: {"value": v if math.isfinite(v) else str(v), "limit": limits[k]}
              for k, v in numbers.items()}
    return json.dumps({**result, "checks": checks}, allow_nan=False)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    import torch

    from benchmark import registry

    wl = registry.workload(registry.load_benchmark(ROOT), a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"benchmark: {wl['chips']} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    result, numbers, limits = run_cell(a.workload, a.seed, a.seconds, bool(a.trace), device)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: modules loaded that the benchmark may not load: {bad}",
              file=sys.stderr)
        return 3
    for k, v in numbers.items():
        print(f"check {k} {v!r} limit {limits[k]!r}", file=sys.stderr)
    sys.stderr.flush()
    print(result_line(result, numbers, limits))
    return 0


if __name__ == "__main__":
    sys.exit(main())
