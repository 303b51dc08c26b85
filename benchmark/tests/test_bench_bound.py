"""The frozen decision arithmetic against hand counts."""

from __future__ import annotations

import pytest

from benchmark import bound, registry
from benchmark.cell import reference
from benchmark.run import ROOT

BENCH = registry.load_benchmark(ROOT)


def test_k3_flagship_bound():
    # PERF.md's K3 flagship call: 120 problems, M = 8, R = 1000, S = 1000, n = 6
    assert bound.decisions(120, 1000, 6, 1000, rungs=8) == 5_760_000_000
    s = bound.call_seconds([(120, 1000, 6, 1000, 8, 120)])
    assert s * 1e3 == pytest.approx(4.986, abs=5e-4)


def test_flagship_sweep_step_decisions():
    # ten seeds of 60 problems, both phases at n = 6: 7.2e9 decisions
    assert 2 * bound.decisions(600, 1000, 6, 1000) == 7_200_000_000
    # the model's own count: 5 free units clamped, 6 free
    assert bound.decisions(600, 1000, 5, 1000) + bound.decisions(600, 1000, 6, 1000) \
        == 6_600_000_000


def test_operations_bound_the_sweep_step():
    s = bound.call_seconds([(600, 1000, 5, 1000, 1, 10), (600, 1000, 6, 1000, 1, 10)])
    assert s == pytest.approx(6.6e9 * 29 / 33.5e12)


@pytest.mark.parametrize("name,clamped,unclamped", [("flat_h5", 5, 6), ("cdqbm_a", 716, 717)])
def test_free_units_by_hand(name, clamped, unclamped):
    cfg = registry.config(BENCH, ROOT, name)
    assert cfg["free_units"] == {"clamped": clamped, "unclamped": unclamped}
    assert reference(cfg).free_units(cfg["model"]) == cfg["free_units"]


def test_epoch_bounds():
    cfg = registry.config(BENCH, ROOT, "flat_h5")
    # 546 rows x 10 seeds x 11 units + 78 rows x 10 seeds x 6 units, x 1e6 reads x sweeps
    d = (546 * 10 * 11 + 78 * 10 * 6) * 1e6
    assert bound.epoch_seconds(cfg, registry.mix("sweep10_sa")) == pytest.approx(
        d * 29 / 33.5e12, rel=1e-9)
    assert bound.epoch_seconds(cfg, registry.mix("sweep10_pt")) == pytest.approx(
        8 * d * 29 / 33.5e12, rel=1e-9)
    calls = bound.epoch_calls(cfg, registry.mix("single_sa"))
    assert len(calls) == 10 + 1 and calls[-2][0][0] == 546 - 9 * 60
    cd = registry.config(BENCH, ROOT, "cdqbm_a")
    calls = bound.epoch_calls(cd, registry.mix("single_sa"))
    assert len(calls) == 28 + 3 and calls[-1][0][0] == 78 - 2 * 32
