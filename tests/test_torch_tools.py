"""The port's user tools on the CPU, against qbmx where it has the tool:
``cli/reload_best_model.py`` (``scripts/reload_best_model.py``),
``cli/anneal_time_bench.py`` (``scripts/anneal_time_bench.py``) and
``cli/seed_bands.py`` (North-star check 3's parity rule).

- ``reload_best_model`` reloads the best-epoch pickles of a port sweep,
  and of a ``qbmx`` sweep written here, on synthetic data, and reproduces
  each seed's recorded best-epoch accuracy and AUC within 0.03: the
  sweep predicted with 1000 reads, the reload with 4000, both at 20
  sweeps, so the predicted marginals differ by sampling noise alone
  (~0.016 at a marginal of 0.5), which moves at most a few of 100 test
  images across the 0.5 line.
- ``anneal_time_bench`` writes the script's CSV columns, mapped to the
  port's solvers, with its device sidecar, and refuses ``--plot`` with a
  clear message where matplotlib is absent.
- ``seed_bands`` holds for two folders of the same sweep, and fails for the
  control: the same flags with the rate cut tenfold.
"""

from __future__ import annotations

import csv
import pickle
import sys

import numpy as np
import pytest
import torch

from qbmx.cli import qbm_main as jmain
from qbmx_torch.cli import anneal_time_bench, reload_best_model, seed_bands
from qbmx_torch.cli import qbm_main as tmain

torch.set_num_threads(1)
SWEEP = dict(data_set="synthetic", n_hidden_nodes=2, sample_count=1000, anneal=20,
             batch_size=100, epochs=2, learning_rate=0.05, seed_sweep=[3, 4])
REPRO_ATOL = 0.03


def _recorded(folder, seeds):
    """Each seed's best-epoch (acc, auc) from the sweep's per-epoch pickles,
    at the best 0.5·acc + 0.5·auc epoch."""
    out = {}
    for s in seeds:
        acc = pickle.load(open(folder / f"acc_per_epoch{s}.pkl", "rb"))
        auc = pickle.load(open(folder / f"auc_per_epoch{s}.pkl", "rb"))
        e = int(np.argmax(0.5 * np.asarray(acc) + 0.5 * np.asarray(auc)))
        out[str(s)] = (acc[e], auc[e])
    return out


@pytest.mark.parametrize("package", ["port", "qbmx"])
def test_reload_best_model_reproduces_the_recorded_metrics(tmp_path, package):
    save = tmp_path / "sweep"
    if package == "port":
        accs, aucs = tmain.main(device="cpu", save=f"{save}/", name="", **SWEEP)
    else:
        accs, aucs = jmain.main(save=f"{save}/", name="", **SWEEP)
    recorded = _recorded(save, SWEEP["seed_sweep"])
    assert [v[0] for v in recorded.values()] == pytest.approx(accs)
    got = reload_best_model.main([str(save / "best_model"), "--data_set", "synthetic",
                                  "--hnodes", "2", "--seed", "19", "--anneal", "20",
                                  "--device", "cpu"])
    assert sorted(s for s, _, _ in got) == sorted(recorded)
    for s, acc, auc in got:
        assert abs(acc - recorded[s][0]) <= REPRO_ATOL and abs(auc - recorded[s][1]) <= REPRO_ATOL


def test_reload_best_model_reads_the_split_qbm_main_draws():
    """Without ``--seed`` the tool reloads onto the split a ``qbm_main``
    sweep run without ``-s`` was trained and validated on."""
    assert reload_best_model.build_parser().get_default("seed") == \
        tmain.build_parser().get_default("seed") == 3492574433


def test_reload_best_model_refuses_a_mismatched_config(tmp_path):
    save = tmp_path / "sweep"
    tmain.main(device="cpu", save=f"{save}/", name="", **{**SWEEP, "epochs": 1,
                                                          "seed_sweep": [3]})
    with pytest.raises(SystemExit, match="--hnodes/--restricted must match"):
        reload_best_model.main([str(save / "best_model"), "--data_set", "synthetic",
                                "--hnodes", "3", "--seed", "19", "--device", "cpu"])
    with pytest.raises(SystemExit, match="no \\*_best.pkl"):
        reload_best_model.main([str(tmp_path), "--device", "cpu"])


def test_anneal_time_bench_writes_the_scripts_csv(tmp_path):
    out = tmp_path / "bench" / "anneal_time_per_qbm_size.csv"
    rows = anneal_time_bench.main(["--device", "cpu", "--sizes", "4", "9", "--reads", "4",
                                   "--sweeps", "3", "--batch", "2",
                                   "--out", str(out)])
    with open(out) as f:
        table = list(csv.reader(f))
    native = ["SA-NATIVE"] if anneal_time_bench.native_built() else []
    assert table[0] == ["n", "SA", "SA-TORCH", "BMS", *native, "SA-GROUPS", "BMS-GROUPS"]
    assert [r[0] for r in table[1:]] == ["4", "9"] and len(rows) == 2
    assert all(float(v) > 0 for r in table[1:] for v in r[1:])
    sidecar = out.with_suffix(".device.txt").read_text().splitlines()
    assert sidecar[0].startswith("device: cpu (host clock); reads 4, sweeps 3, batch 2, seed 0")


def test_anneal_time_bench_takes_the_dense_columns_asked_for(tmp_path):
    out = tmp_path / "a.csv"
    anneal_time_bench.main(["--device", "cpu", "--sizes", "4", "--reads", "2", "--sweeps", "2",
                            "--batch", "2", "--solvers", "SA", "BMS",
                            "--out", str(out)])
    assert out.read_text().splitlines()[0] == "n,SA,BMS,SA-GROUPS,BMS-GROUPS"


def test_anneal_time_bench_draws_the_same_problems_from_its_seed(monkeypatch):
    """Every column anneals the problems drawn from ``--seed``: the same
    problems on every run."""
    seen = []
    real = anneal_time_bench.densify_groups
    monkeypatch.setattr(anneal_time_bench, "densify_groups",
                        lambda Qs, h: seen.append(real(Qs, h)) or seen[-1])
    for _ in range(2):
        anneal_time_bench.bench([5], reads=2, sweeps=2, batch=2, reps=1, device="cpu",
                                solvers=["SA"])
    assert torch.equal(seen[0], seen[1])


def test_anneal_time_bench_plot_refuses_without_matplotlib(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="needs matplotlib"):
        anneal_time_bench.main(["--device", "cpu", "--sizes", "4", "--plot",
                                "--out", str(tmp_path / "a.csv")])
    assert not (tmp_path / "a.csv").exists()  # refused before timing anything


# PERF.md §2's setting (10 seeds, 4 epochs): the sweep twice, and the lr/10 control
BANDS = dict(data_set="synthetic", n_hidden_nodes=2, sample_count=16, anneal=20, batch_size=60,
             epochs=4, seed_sweep=list(range(10)))


def test_seed_bands_hold_for_the_same_sweep_and_fail_the_control(tmp_path, capsys):
    for folder, lr in (("a", 0.03), ("b", 0.03), ("control", 0.003)):
        tmain.main(device="cpu", save=f"{tmp_path / folder}/", learning_rate=lr, **BANDS)
    assert seed_bands.main([str(tmp_path / "a"), str(tmp_path / "b")]) == 0
    assert seed_bands.main([str(tmp_path / "a"), str(tmp_path / "control")]) == 1
    out = capsys.readouterr().out
    assert "parity rule HOLDS" in out and "parity rule FAILS" in out and "OUT" in out


def test_seed_bands_rule_and_report(tmp_path, capsys):
    """The rule on written-out pickles: three seeds, each sweep's sd 0.1 at
    every epoch, so the half-width is 2·sqrt(2·0.1²/3) ≈ 0.1633; a mean
    shifted a hair inside it holds, a hair past it fails; folders without a
    seed's pair of pickles, or with other seeds, are refused."""
    ref = {"acc": [[0.5, 0.7], [0.6, 0.8], [0.7, 0.9]], "auc": [[0.5, 0.7], [0.6, 0.8],
                                                               [0.7, 0.9]]}
    half = 2 * np.sqrt(2 * 0.1**2 / 3)
    for name, shift, seeds in (("ref", 0.0, (0, 1, 2)), ("edge", half - 1e-9, (0, 1, 2)),
                               ("past", half + 1e-6, (0, 1, 2)), ("other", 0.0, (0, 1, 5))):
        d = tmp_path / name
        d.mkdir()
        for m in ("acc", "auc"):
            for s, hist in zip(seeds, ref[m]):
                with open(d / f"run{m}_per_epoch{s}.pkl", "wb") as f:
                    pickle.dump([v + shift for v in hist], f)
    assert seed_bands.main([str(tmp_path / "ref"), str(tmp_path / "edge")]) == 0
    assert seed_bands.main([str(tmp_path / "ref"), str(tmp_path / "past")]) == 1
    out = capsys.readouterr().out
    assert "epoch 1: acc ref 0.6000 [0.5000, 0.7000] sd 0.1000" in out
    assert f"of ±{half:.4f} OUT" in out
    with pytest.raises(SystemExit, match="ran seeds"):
        seed_bands.main([str(tmp_path / "ref"), str(tmp_path / "other")])
    (tmp_path / "ref" / "runauc_per_epoch2.pkl").unlink()
    with pytest.raises(SystemExit, match="for the same seeds"):
        seed_bands.load_bands(tmp_path / "ref")
