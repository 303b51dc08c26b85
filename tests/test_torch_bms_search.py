"""The breastmnist search tools and the data synthesizer on the CPU,
against ``qbmx``'s scripts: ``cli/bms_hyper_search.py``,
``cli/bms_winner_curves.py`` and ``cli/synthesize_missing_data.py``
(``scripts/bms_hyper_search.py``, ``bms_winner_curves.py``,
``synthesize_missing_data.py``), and what every new CLI shares.

- Each CLI keeps its script's flags and defaults, plus ``--device``
  (default ``cuda``); the three studies, which take no flags, take only
  ``--device``.  With the default ``--device cuda`` and no card, each
  raises before it reads or writes anything: no CPU fallback.
- Both packages' ``run_config``, with ``SeedParallelDQBM`` replaced here by
  one returning the same fixed histories, write equal JSONL records apart
  from ``time_s``; both ``main``s write the same records for the same
  ``--configs``/``--seeds``.  The winner curves write equal JSON apart from
  ``time_s`` and print the same fronts.  Each builds its sweep with the
  script's arguments (``epoch_segment`` aside: it serves the TPU's scan).
- One real ``run_config`` (h2, sc16, anneal 20, 3 seeds, one epoch) on the
  CPU's plain path writes a well-formed record with ``qbmx``'s keys.
- The synthesizer writes the script's files byte for byte, with and
  without the reference label streams.
"""

from __future__ import annotations

import argparse
import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from qbmx_torch.cli import bms_hyper_search as th
from qbmx_torch.cli import bms_winner_curves as tw
from qbmx_torch.cli import cdqbm_breast_exact_study as tb
from qbmx_torch.cli import cdqbm_exact_study as ts
from qbmx_torch.cli import cdqbm_multikernel_study as tk
from qbmx_torch.cli import synthesize_missing_data as tsyn
from qbmx_torch.data.synthesize import write_idx1
from chip_smoke import write_medmnist
from scripts import bms_hyper_search as jh
from scripts import bms_winner_curves as jw
from scripts import synthesize_missing_data as jsyn

torch.set_num_threads(1)
PAIRS = {"bms_hyper_search": (th, jh), "bms_winner_curves": (tw, jw)}
STUDIES = (ts, tb, tk)


class _Parsed(Exception):
    pass


def _script_parser(module):
    """The parser a script's ``main`` builds, caught at ``parse_args``."""
    caught = {}

    def parse(self, args=None, namespace=None):
        caught["parser"] = self
        raise _Parsed

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", parse)
        with pytest.raises(_Parsed):
            module.main()
    return caught["parser"]


def _flags(parser) -> dict:
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.choices, a.nargs)
            for a in parser._actions}


@pytest.mark.parametrize("name", list(PAIRS))
def test_flags_and_defaults_are_the_scripts(name):
    ours, theirs = PAIRS[name]
    flags = _flags(ours.build_parser())
    device = flags.pop("device")
    assert device[:2] == (("--device",), "cuda")
    assert flags == _flags(_script_parser(theirs))


@pytest.mark.parametrize("study", STUDIES, ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_studies_take_only_device(study):
    flags = _flags(study.build_parser())
    assert set(flags) == {"help", "device"} and flags["device"][1] == "cuda"


@pytest.mark.parametrize("module", [*STUDIES, th, tw],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_default_device_raises_without_a_card(module, tmp_path, monkeypatch):
    assert not torch.cuda.is_available()
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main([])
    assert list(tmp_path.iterdir()) == []  # nothing read, nothing written


# -- the search and the curves with fixed histories ----------------------------


def _histories(seeds, epochs=4):
    """Fixed per-seed histories, some epochs past both reference numbers."""
    r = np.random.default_rng(len(seeds))
    out = []
    for _ in seeds:
        acc = r.uniform(0.80, 0.87, epochs)
        auc = r.uniform(0.78, 0.85, epochs)
        out.append(types.SimpleNamespace(acc_per_epoch=[float(v) for v in acc],
                                         auc_per_epoch=[float(v) for v in auc],
                                         prob_auc_per_epoch=[float(v) for v in auc[::-1]]))
    return out


def _fake_sweep(calls):
    class FakeSweep:
        def __init__(self, seeds, **kw):
            self.seeds = list(seeds)
            calls.append(kw)

        def train(self, train_X, train_y, test_X, test_y, **kw):
            calls.append(kw)
            return _histories(self.seeds, kw["epochs"])

    return FakeSweep


DATA = ((np.zeros((6, 784), np.float32), np.zeros(6)), (np.zeros((4, 784), np.float32),
                                                        np.zeros(4)))
CFGS = [{"solver": "SA", "h": 5, "lr": 0.307, "e": 3},
        {"solver": "PT", "h": 2, "lr": 0.453, "sweeps": 128, "e": 4, "bs": 36,
         "beta_eff": 2.0}]


def _records(path: Path) -> list[dict]:
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    for r in recs:
        r.pop("time_s")
    return recs


def test_run_config_writes_qbmx_records(tmp_path, monkeypatch):
    calls = {"port": [], "qbmx": []}
    monkeypatch.setattr(th, "SeedParallelDQBM", _fake_sweep(calls["port"]))
    monkeypatch.setattr(jh, "SeedParallelDQBM", _fake_sweep(calls["qbmx"]))
    seeds = (list(th.DEFAULT_SEEDS) + th.EXTRA_SEEDS)[:12]
    for cfg in CFGS:
        th.run_config(DATA, cfg, seeds, tmp_path / "port.jsonl", device="cpu")
        jh.run_config(DATA, cfg, seeds, tmp_path / "qbmx.jsonl")
    ours, theirs = _records(tmp_path / "port.jsonl"), _records(tmp_path / "qbmx.jsonl")
    assert ours == theirs and any(r["any_beats_ref"] for r in ours)
    for a, b in zip(calls["port"], calls["qbmx"]):
        assert a.pop("device", "cpu") == "cpu"
        b.pop("epoch_segment", None)
        assert a == b


@pytest.fixture
def breast_cwd(tmp_path, monkeypatch):
    """A working directory holding ``chip_smoke.py``'s seeded
    ``data/medmnist/*.npz`` of MedMNIST's shapes; both packages search
    ``./data``."""
    write_medmnist(tmp_path / "data")
    monkeypatch.delenv("QBMX_DATA_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    return tmp_path


def test_search_main_writes_qbmx_records(breast_cwd, monkeypatch, capsys):
    monkeypatch.setattr(th, "SeedParallelDQBM", _fake_sweep([]))
    monkeypatch.setattr(jh, "SeedParallelDQBM", _fake_sweep([]))
    monkeypatch.setattr(jh, "OUT", breast_cwd / "out/parity")
    (breast_cwd / "out/parity").mkdir(parents=True)
    argv = ["--configs", json.dumps(CFGS), "--seeds", "3"]
    th.main([*argv, "--device", "cpu"])
    port_out = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["bms_hyper_search.py", *argv])
    jh.main()
    assert capsys.readouterr().out == port_out
    assert (_records(breast_cwd / "out/parity_torch/bms_hyper_search.jsonl")
            == _records(breast_cwd / "out/parity/bms_hyper_search.jsonl"))


def test_winner_curves_write_qbmx_json_and_fronts(breast_cwd, monkeypatch, capsys):
    calls = {"port": [], "qbmx": []}
    monkeypatch.setattr(tw, "SeedParallelDQBM", _fake_sweep(calls["port"]))
    monkeypatch.setattr(jw, "SeedParallelDQBM", _fake_sweep(calls["qbmx"]))
    # the script writes beside its own folder: point it at this directory
    monkeypatch.setattr(jw, "__file__", str(breast_cwd / "scripts" / "bms_winner_curves.py"))
    (breast_cwd / "out/parity").mkdir(parents=True)
    argv = ["--e", "3", "--seeds", "32", "--predict_reads", "100", "--out_tag", "_t"]
    tw.main([*argv, "--device", "cpu"])
    port_out = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["bms_winner_curves.py", *argv])
    jw.main()
    assert capsys.readouterr().out == port_out
    assert "Pareto front" in port_out and "prob-scored AUC" in port_out
    ours, theirs = (json.loads((breast_cwd / f"out/{d}/bms_winner_curves_t.json").read_text())
                    for d in ("parity_torch", "parity"))
    ours.pop("time_s")
    theirs.pop("time_s")
    assert ours == theirs and len(ours["curves"]) == 32
    assert str(calls["port"][0].pop("device")) == "cpu"
    calls["qbmx"][0].pop("epoch_segment")
    assert calls["port"] == calls["qbmx"]


def test_real_run_config_on_the_cpu(breast_cwd):
    """The plain path end to end: 3 seeds, one epoch of 28 steps at h2,
    16 reads of 20 sweeps."""
    data = th.breast_data()
    seeds = (list(th.DEFAULT_SEEDS) + th.EXTRA_SEEDS)[:3]
    cfg = {"solver": "SA", "h": 2, "lr": 0.307, "sc": 16, "sweeps": 20, "e": 1}
    path = breast_cwd / "out/parity_torch/bms_hyper_search.jsonl"
    rec = th.run_config(data, cfg, seeds, path, device="cpu")
    assert [json.loads(line) for line in path.read_text().splitlines()] == [rec]
    assert set(rec) == {"cfg", "n_seeds", "time_s", "mean_acc", "std_acc", "mean_auc",
                        "best_single", "any_beats_ref", "per_seed"}
    assert rec["n_seeds"] == 3 and [p["seed"] for p in rec["per_seed"]] == seeds
    for p in rec["per_seed"]:
        assert 0.0 <= p["acc"] <= 1.0 and 0.0 <= p["auc"] <= 1.0 and p["epoch"] == 1
    assert rec["best_single"]["acc"] == max(p["acc"] for p in rec["per_seed"])


# -- the synthesizer --------------------------------------------------------------


def _tree(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


@pytest.mark.parametrize("labels", [False, True], ids=["synthetic labels", "reference labels"])
def test_synthesizer_writes_the_scripts_files(tmp_path, monkeypatch, labels):
    ref = tmp_path / "ref"
    if labels:
        r = np.random.default_rng(4)
        write_idx1(ref / "train-labels-idx1-ubyte", r.integers(0, 10, 5000))
        write_idx1(ref / "t10k-labels-idx1-ubyte", r.integers(0, 10, 1200))
    monkeypatch.setattr(tsyn, "REF_FASHION", ref)
    monkeypatch.setattr(jsyn, "REF_FASHION", ref)
    tsyn.main(str(tmp_path / "port"))
    jsyn.main(str(tmp_path / "qbmx"))
    ours, theirs = _tree(tmp_path / "port"), _tree(tmp_path / "qbmx")
    assert ours == theirs and len(ours) == 10


def test_synthesizer_default_destination(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    d1, d2 = tsyn.main()
    assert (d1, d2) == (Path("data/fashionmnist"), Path("data/cifar-10-batches-py"))
