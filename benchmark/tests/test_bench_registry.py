"""BENCHMARK.json and the files it names: every cell finds its
configuration, mix, limits and metric readers by name, and the file keeps
to the contract's shape."""

from __future__ import annotations

import json
import re

import numpy as np
import pytest

from benchmark import registry
from benchmark.run import ROOT

BENCH = registry.load_benchmark(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"][1].startswith("benchmark/")
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cell", CELLS)
def test_cell_finds_its_files(cell):
    wl = registry.workload(BENCH, cell)
    assert wl["name"] == f"{wl['config']}.{wl['traffic']}"
    cfg = registry.config(BENCH, ROOT, wl["config"])
    mix = registry.mix(wl["traffic"])
    assert mix["entry"] in ("single", "sweep")
    assert set(registry.limits(cell)) >= {"qubo_gap", "loss_gap", "grad_gap", "change_gap",
                                          "sample_z", "predict_gap"}
    assert registry.settings(cfg, mix)["batch"] > 0
    e2e = {m["name"] for m in registry.metrics_of(BENCH, "end_to_end", cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = registry.metrics_of(BENCH, "per_layer", cell)
    assert layers and all(m["moves"] in e2e for m in layers)


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        registry.workload(BENCH, "no_such.cell")
    with pytest.raises(KeyError):
        registry.config(BENCH, ROOT, "no_such_config")


@pytest.mark.parametrize("entry", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader_found_by_name(entry):
    assert NAME.match(entry["name"])
    assert callable(registry.metric(entry["name"]).read)
    assert entry["better"] in ("lower", "higher")
    for w in entry.get("workloads", []):
        assert w in CELLS


def test_names_and_configs():
    names = [c["name"] for c in BENCH["configs"]] + CELLS
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("benchmark/") and cfg["reduced"] == c["reduced"]
    assert all(m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_every_seed_gets_the_same_images_in_another_order():
    from benchmark import data

    cfg = registry.config(BENCH, ROOT, "flat_h5")
    a, b, a2 = data.make(cfg, 1), data.make(cfg, 2**31 + 5), data.make(cfg, 1)
    assert all((a[k] == a2[k]).all() for k in a)
    assert not (a["train_X"] == b["train_X"]).all()
    for k in ("train_X", "val_X"):
        assert (np.sort(a[k], axis=0) == np.sort(b[k], axis=0)).all()
    assert sorted(a["train_y"]) == sorted(b["train_y"])
