"""The port's spans (``qbmx_torch/utils/spans.py``) and the benchmark's
readers of them (``benchmark/spans.py``, ``benchmark/metrics/``).

On the CPU: ``span`` is a shared no-op without a profiler; under one, a
tiny epoch through each training entry the benchmark's cells use nests
``qbmx.train`` ⊃ ``qbmx.epoch`` ⊃ ``qbmx.step`` ⊃ ``qbmx.sampler`` ⊃
``qbmx.sampler.wrapper`` with one step a batch, one sampler call a step
and a validation call, one validation (⊃ ``qbmx.predict``) an epoch and
the loss fetch as a ``qbmx.sync.*`` span; a
hand-built trace gives each reader its known value, and the four idle
readers add up to the idle time inside ``qbmx.train``.

On the card (``-m cuda``): one epoch of each cell at its own size, under
``benchmark/trace.profile``, has every host sync inside a ``qbmx.sync.*``
span, no ``qbmx.`` name among its device operations, and as many
``qbmx.sampler`` spans as the harness counted sampler calls."""

from __future__ import annotations

import collections
import random
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import registry
from benchmark import spans as bspans
from benchmark.run import ROOT
from benchmark.trace import Trace
from qbmx_torch.models.cdqbm import CDQBM
from qbmx_torch.models.dqbm import DiscQBM
from qbmx_torch.train.loop import train_model
from qbmx_torch.train.sweep import SeedParallelDQBM
from qbmx_torch.utils import spans

IDLE_READERS = ("sampler_idle_pct", "step_idle_pct", "validate_idle_pct", "epoch_idle_pct")
READERS = IDLE_READERS + ("host_syncs_per_step", "validate_share_pct")


def test_span_is_a_shared_no_op_without_a_profiler():
    assert spans.span("step") is spans.span("sync.epoch_nll") is spans._IDLE
    with spans.span("step") as got:
        assert got is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(4).sum()
    assert not [e.name for e in prof.events() if e.name.startswith(spans.PREFIX)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("step"):
            torch.ones(4).sum()
    assert [e.name for e in prof.events() if e.name.startswith(spans.PREFIX)] == ["qbmx.step"]


# -- one tiny epoch through each entry -----------------------------------------

RNG = np.random.default_rng(5)
TRAIN, VAL, BATCH = 20, 6, 8  # three batches, the last partial; validation in one call


def _flat_data(dim):
    x = RNG.random((TRAIN, dim), dtype=np.float32)
    vx = RNG.random((VAL, dim), dtype=np.float32)
    return x, np.arange(TRAIN) % 2, vx, np.arange(VAL) % 2


def _single_dqbm():
    x, y, vx, vy = _flat_data(16)
    model = DiscQBM(dim_input=16, n_hidden_nodes=2, sample_count=4, anneal_steps=3,
                    device="cpu", seed=1)
    return lambda: train_model(model, x, y, vx, vy, batch_size=BATCH, epochs=1,
                               verbose=False)


def _sweep_dqbm():
    x, y, vx, vy = _flat_data(16)
    sweep = SeedParallelDQBM([1, 2], dim_input=16, n_hidden_nodes=2, sample_count=4,
                             anneal_steps=3, device="cpu")
    return lambda: sweep.train(x, y, vx, vy, epochs=1, batch_size=BATCH, verbose=False)


def _single_cdqbm():
    x, y, vx, vy = _flat_data(64)
    model = CDQBM(image_shape=(8, 8), pooling_size=2, pooling_type="probabilistic",
                  sequential_layer_sizes=[2], hidden_bias_type="shared", anneal=2,
                  sample_count=2, device="cpu", seed=3)
    return lambda: train_model(model, x, y, vx, vy, batch_size=BATCH, epochs=1,
                               verbose=False)


ENTRIES = {"train_model_dqbm": _single_dqbm, "sweep_dqbm": _sweep_dqbm,
           "train_model_cdqbm": _single_cdqbm}


def _program_spans(run) -> dict:
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    out = collections.defaultdict(list)
    for e in prof.events():
        if e.name.startswith(spans.PREFIX):
            out[e.name].append((e.time_range.start, e.time_range.end))
    return out


def _inside(child, parents) -> bool:
    return any(s <= child[0] and child[1] <= e for s, e in parents)


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_an_epoch_nests_its_spans(entry):
    got = _program_spans(ENTRIES[entry]())
    steps = -(-TRAIN // BATCH)
    assert len(got["qbmx.train"]) == len(got["qbmx.epoch"]) == len(got["qbmx.validate"]) == 1
    assert len(got["qbmx.step"]) == steps
    assert len(got["qbmx.sampler"]) == steps + 1
    assert len(got["qbmx.predict"]) == 1
    assert len(got["qbmx.sampler.wrapper"]) == len(got["qbmx.sampler"])
    for child, parent in (("qbmx.epoch", "qbmx.train"), ("qbmx.step", "qbmx.epoch"),
                          ("qbmx.validate", "qbmx.epoch"), ("qbmx.predict", "qbmx.validate"),
                          ("qbmx.sampler.wrapper", "qbmx.sampler")):
        assert all(_inside(c, got[parent]) for c in got[child]), (child, parent)
    # every sampler call is a step's or validation's
    assert all(_inside(c, got["qbmx.step"] + got["qbmx.validate"]) for c in got["qbmx.sampler"])
    assert sum(_inside(c, got["qbmx.validate"]) for c in got["qbmx.sampler"]) == 1
    assert got["qbmx.sync.epoch_nll"] and all(_inside(c, got["qbmx.epoch"])
                                              for c in got["qbmx.sync.epoch_nll"])
    assert not any(_inside(c, got["qbmx.step"]) for c in got["qbmx.sync.epoch_nll"])


# -- the readers on hand-built traces ---------------------------------------------


def _trace(device_ops, host_ops, window_s=1e-4, steps=2) -> Trace:
    return Trace(device_ops=[("k", s, e) for s, e in device_ops], host_ops=host_ops,
                 window_s=window_s, steps=steps, sampler_calls=3, launches={}, bound_s=0.0)


def _read(name, trace):
    return registry.metric(name).read(types.SimpleNamespace(trace=trace))


# µs on one clock: train 0-100; a step 10-40 holding a sampler call 15-35;
# validation 50-80 holding a sampler call 55-65; the device busy 0-5,
# 20-30, 60-62 and 90-100; three syncs
KNOWN = _trace(
    device_ops=[(0, 5), (20, 30), (60, 62), (90, 100), (95, 98)],
    host_ops=[("qbmx.train", 0, 100), ("qbmx.epoch", 1, 99), ("qbmx.step", 10, 40),
              ("qbmx.sampler", 15, 35), ("qbmx.sync.beta_inf", 16, 18),
              ("qbmx.validate", 50, 80), ("qbmx.sampler", 55, 65),
              ("qbmx.sync.val_fetch", 66, 70), ("qbmx.sync.epoch_nll", 45, 48),
              ("aten::add", 20, 21), ("bench.step", 9, 41)],
    window_s=200e-6)
KNOWN_VALUES = {
    # idle in the train span: 5-20, 30-60, 62-90 (73 µs) of a 200 µs window
    "sampler_idle_pct": 100 * (5 + 5 + 8) / 200,  # 15-20, 30-35, 55-60 and 62-65
    "step_idle_pct": 100 * (5 + 5) / 200,  # 10-15, 35-40
    "validate_idle_pct": 100 * (5 + 15) / 200,  # 50-55, 65-80
    "epoch_idle_pct": 100 * (5 + 10 + 10) / 200,  # 5-10, 40-50, 80-90
    "host_syncs_per_step": 3 / 2,
    "validate_share_pct": 100 * 30 / 200,
}


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_its_known_value(name):
    assert _read(name, KNOWN) == pytest.approx(KNOWN_VALUES[name])
    # a traced program without the spans, and a run without a trace: nothing
    bare = _trace([(0, 5)], [("bench.step", 0, 10), ("aten::add", 1, 2)])
    assert _read(name, bare) is None and _read(name, None) is None


def test_idle_readers_sum_to_the_idle_time_inside_train():
    assert sum(KNOWN_VALUES[n] for n in IDLE_READERS) == pytest.approx(100 * 73 / 200)
    rnd = random.Random(11)
    for _ in range(200):
        iv = lambda k: [(a, a + rnd.randint(1, 30)) for a in rnd.sample(range(200), k)]
        host = [(name, s, e) for name, k in (("qbmx.train", 2), ("qbmx.step", 4),
                                              ("qbmx.validate", 2), ("qbmx.sampler", 4))
                for s, e in iv(k)]
        t = _trace(iv(8), host, window_s=300e-6)
        idle = bspans.union_us(bspans.subtract(bspans.spans(t, "qbmx.train"),
                                             bspans.merge((s, e) for _, s, e in t.device_ops)))
        assert sum(_read(n, t) for n in IDLE_READERS) == pytest.approx(100 * idle / 300)


def test_interval_arithmetic_matches_a_grid():
    rnd = random.Random(3)
    for _ in range(200):
        iv = lambda: bspans.merge((a, a + rnd.randint(0, 9)) for a in
                                  (rnd.randint(0, 60) for _ in range(rnd.randint(0, 6))))
        a, b = iv(), iv()
        grid = lambda x: {t for s, e in x for t in range(s, e)}
        assert grid(bspans.intersect(a, b)) == grid(a) & grid(b)
        assert grid(bspans.subtract(a, b)) == grid(a) - grid(b)
        assert bspans.union_us(bspans.subtract(a, b)) == len(grid(a) - grid(b))


# -- on the card: every host sync of a cell's epoch inside a qbmx.sync span ------

CELLS = [w["name"] for w in registry.load_benchmark(ROOT)["workloads"]]
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_every_host_sync_of_a_cells_epoch_is_a_span(card, cell):
    from benchmark.run import build, warm_up
    from benchmark.trace import profile as bench_profile

    b = build(cell, 2**31 + 101, card)
    warm_up(b)
    b.rec.sampler_calls = 0
    dev_ops, host_ops, _ = bench_profile(lambda: b.cell.epoch(2, False), card)
    assert not [n for n, _, _ in dev_ops if n.startswith(spans.PREFIX)]
    train = [(s, e) for n, s, e in host_ops if n == "qbmx.train"]
    sync_spans = [(s, e) for n, s, e in host_ops if n.startswith("qbmx.sync.")]
    waits = [(n, s, e) for n, s, e in host_ops if n in SYNCS and _inside((s, e), train)]
    bare = [(s, e) for _, s, e in waits if not _inside((s, e), sync_spans)]
    where = [sorted(((e2 - s2, n2) for n2, s2, e2 in host_ops if s2 <= s and e <= e2))[:4]
             for s, e in bare]
    assert waits and not bare, where
    sampler = [1 for n, _, _ in host_ops if n == "qbmx.sampler"]
    assert len(sampler) == b.rec.sampler_calls
