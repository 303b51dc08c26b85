"""A whole run of each cell, cut to a CPU size (``bench_tiny``), past the
harness's look for a chip: the result line's schema, a sound run judged
correct, every planted fault and the control judged not correct."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import check, registry
from benchmark.control import reading
from benchmark.run import ROOT, result_line, run_cell
from benchmark.tests.bench_tiny import tiny

CELLS = [w["name"] for w in registry.load_benchmark(ROOT)["workloads"]]
CPU = torch.device("cpu")
SEED = 2**31 + 977  # past 32 signed bits, as the driver's seeds are


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct_and_its_line_keeps_the_schema(cell):
    result, numbers, limits = run_cell(cell, SEED, 0.2, False, CPU, shape=tiny)
    line = json.loads(result_line(result, numbers, limits))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, numbers
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    bench = registry.load_benchmark(ROOT)
    want = {m["name"] for m in registry.metrics_of(bench, "end_to_end", cell)}
    assert set(line["metrics"]) == want
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert set(line["checks"]) == set(check.NUMBERS)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered_samples",
                                   "altered_answers", "mask_ignored"])
@pytest.mark.parametrize("cell", CELLS)
def test_planted_fault_is_not_correct(cell, fault):
    result, numbers, _ = run_cell(cell, SEED + 1, 0.2, False, CPU, fault=fault, shape=tiny)
    assert result["correct"] is False, numbers


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    numbers = reading(cell, SEED + 2, "control", CPU, shape=tiny)
    assert not check.verdict(numbers, registry.limits(cell)), numbers


def test_non_finite_numbers_print_as_strings():
    nums = {k: 0.0 for k in check.NUMBERS}
    nums["sample_z"] = float("inf")
    line = json.loads(result_line({"correct": False}, nums, {k: 1.0 for k in nums}))
    assert line["checks"]["sample_z"]["value"] == "inf"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_sound_reading_on_the_card(card):
    """One sound reading of the flagship sweep at its own size."""
    numbers = reading("flat_h5.sweep10_sa", SEED, "sound", card)
    assert check.verdict(numbers, registry.limits("flat_h5.sweep10_sa")), numbers
