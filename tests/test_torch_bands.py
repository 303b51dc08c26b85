"""The committed seed bands of ``qbmx`` (``out/bands/<setting>/qbmx/``,
written by ``qbmx``'s own CLIs through ``qbmx_torch/cli/bands.py``) and the
rule that holds the port's sweeps to them (North-star check 3).

- Every setting has its reference: seeds 0–9, the same epochs for every
  seed and metric, and a manifest whose command, run again, is the
  setting's; that command parses with ``qbmx``'s parser and with the
  port's to the same flags, the port's adding only ``--device``.
- The Bonferroni width z_k is Φ⁻¹(1 − 0.025/k); ``compare`` at it holds a
  reference against itself and fails it shifted just past the width,
  while ``seed_bands.main`` keeps the width of 2.
- The band phase's routes (``chip_smoke.BAND_ROUTES``) are the layout
  rules' at each setting's step and validation calls.
- The port's CPU sweep of ``flat_sa_h2`` holds ``qbmx``'s band at z_k, one
  sampler call a step and one a validation, and its lr/10 control fails.
"""

from __future__ import annotations

import importlib
import json
import math
import pickle

import numpy as np
import pytest
import torch
from scipy.stats import norm

import chip_smoke
from qbmx_torch.cli import bands, seed_bands

torch.set_num_threads(1)
SETTINGS = list(bands.SETTINGS)
MANIFEST_KEYS = {"setting", "command", "env", "jax_version", "commit", "wall_seconds",
                 "cpu_count", "final_epoch"}


@pytest.mark.parametrize("setting", SETTINGS)
def test_every_setting_has_its_reference(setting):
    folder = bands.reference_dir(setting)
    ref = seed_bands.load_bands(folder)
    assert ref["seeds"] == list(range(10)) == list(bands.SEEDS)
    assert ref["acc"].shape == ref["auc"].shape == (10, bands.epochs(setting))
    assert np.all((ref["acc"] >= 0) & (ref["acc"] <= 1)) and np.all(np.isfinite(ref["auc"]))
    assert sorted(p.name for p in folder.iterdir()) == sorted(
        ["manifest.json"] + [f"run{m}_per_epoch{s}.pkl" for m in seed_bands.METRICS
                             for s in range(10)])
    m = bands.read_manifest(setting)
    assert set(m) == MANIFEST_KEYS and m["setting"] == setting
    assert m["env"] == {"JAX_PLATFORMS": "cpu"} and len(m["commit"]) == 40
    assert m["jax_version"] and m["wall_seconds"] > 0
    module, _ = bands.SETTINGS[setting]
    assert m["command"] == ["python", "-m", f"qbmx.cli.{module}", *bands.argv(setting),
                            "--save", f"out/bands/{setting}/qbmx/"]
    for metric in seed_bands.METRICS:
        last = ref[metric][:, -1]
        assert m["final_epoch"][metric] == pytest.approx(
            {"mean": last.mean(), "sd": last.std(ddof=1), "epochs": bands.epochs(setting)})
    # a setting counts only where qbmx learns
    assert m["final_epoch"]["acc"]["mean"] >= 0.70


@pytest.mark.parametrize("setting", SETTINGS)
def test_manifest_command_parses_alike_in_both_packages(setting):
    args = bands.read_manifest(setting)["command"][3:]
    module, _ = bands.SETTINGS[setting]
    jax_ns = vars(importlib.import_module(f"qbmx.cli.{module}").build_parser().parse_args(args))
    port_ns = vars(importlib.import_module(f"qbmx_torch.cli.{module}").build_parser()
                   .parse_args(args))
    assert port_ns.pop("device") == "cuda"
    assert port_ns == jax_ns
    assert jax_ns["seed_sweep"] == list(range(10))


@pytest.mark.parametrize("k", [1, 8, 24, 68, 72, 84])
def test_bonferroni_z_is_the_normal_quantile(k):
    assert seed_bands.bonferroni_z(k) == pytest.approx(norm.ppf(1 - 0.025 / k), rel=1e-12)


def test_z_all_counts_every_epoch_and_metric():
    k, z = bands.z_all(SETTINGS)
    assert k == sum(2 * bands.epochs(s) for s in SETTINGS) == 84
    assert z == seed_bands.bonferroni_z(k) == pytest.approx(norm.ppf(1 - 0.025 / 84), rel=1e-12)
    assert bands.z_all(["flat_sa_h2"])[0] == 8


def _write(folder, acc, auc):
    folder.mkdir(parents=True)
    for s in range(acc.shape[0]):
        pickle.dump(list(acc[s]), open(folder / f"acc_per_epoch{s}.pkl", "wb"))
        pickle.dump(list(auc[s]), open(folder / f"auc_per_epoch{s}.pkl", "wb"))


@pytest.mark.parametrize("setting", SETTINGS)
def test_compare_at_z_k_holds_itself_and_fails_a_shift_past_it(setting):
    ref = seed_bands.load_bands(bands.reference_dir(setting))
    _, z = bands.z_all(SETTINGS)
    holds, rows = seed_bands.compare(ref, ref, z)
    assert holds and all(r[m]["ok"] for r in rows for m in seed_bands.METRICS)
    # the last epoch's accuracy moved by 1.001 half-widths (the sds stay)
    sd = ref["acc"][:, -1].std(ddof=1)
    half = z * math.sqrt(2 * sd ** 2 / 10)
    for factor, want in ((0.999, True), (1.001, False)):
        moved = dict(ref, acc=ref["acc"].copy())
        moved["acc"][:, -1] -= factor * half
        holds, rows = seed_bands.compare(ref, moved, z)
        assert holds == want and rows[-1]["acc"]["half_width"] == pytest.approx(half)


def test_seed_bands_main_keeps_z_2(tmp_path, capsys):
    rng = np.random.default_rng(7)
    acc = rng.uniform(0.6, 0.9, (10, 2))
    auc = acc + 0.01
    sd = acc[:, -1].std(ddof=1)
    _write(tmp_path / "ref", acc, auc)
    # shifted by 2.5 standard errors of the difference: past Z = 2, within z_k
    shifted = acc.copy()
    shifted[:, -1] -= 2.5 * math.sqrt(2 * sd ** 2 / 10)
    _write(tmp_path / "cand", shifted, auc)
    assert seed_bands.Z == 2.0
    assert seed_bands.main([str(tmp_path / "ref"), str(tmp_path / "cand")]) == 1
    assert "within 2 standard errors" in capsys.readouterr().out
    _, z = bands.z_all(SETTINGS)
    assert seed_bands.report(tmp_path / "ref", tmp_path / "cand", z)


def _calls(setting):
    """The (groups, problems, reads, n) of a setting's step and validation
    calls: 10 seeds, clamped and unclamped groups a step; the test split's
    100 images in one validation call a seed (the CDQBM: chunks of 32)."""
    module, _ = bands.SETTINGS[setting]
    ns = vars(importlib.import_module(f"qbmx_torch.cli.{module}").build_parser()
              .parse_args(bands.argv(setting)))
    R = ns["sample_count"]
    if module == "cdqbm_main":  # the CLI's deterministic pooling: 41 variables
        return [(20, ns["batch_size"], R, 41), (10, 32, R, 41)]
    n = ns["hnodes"] + 1
    return [(20, ns["batch_size"], R, n), (10, 100, R, n)]


@pytest.mark.parametrize("setting", SETTINGS)
def test_band_routes_are_the_layout_rules(setting):
    kernel, route = chip_smoke.BAND_ROUTES[setting]
    assert {chip_smoke.band_route(kernel, *c) for c in _calls(setting)} == {route}


def test_band_routes_cover_every_kernel():
    assert set(chip_smoke.BAND_ROUTES) == set(bands.SETTINGS)
    assert {k for k, _ in chip_smoke.BAND_ROUTES.values()} == {
        "sa_metropolis", "sa_heatbath", "pt_heatbath", "anneal_wide", "pt_wide"}


def test_the_port_holds_flat_sa_h2_on_the_cpu_and_its_control_fails(tmp_path, monkeypatch):
    from qbmx_torch.cli import qbm_main
    from qbmx_torch.samplers.api import sampler_sample_groups
    from qbmx_torch.train.sweep import SeedParallelDQBM

    calls = []

    class Logged(SeedParallelDQBM):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            inner = self.sampler

            class Log:
                def sample_groups(self, generator, Q, h, num_reads):
                    calls.append((*h.shape[:2], num_reads, h.shape[2]))
                    return sampler_sample_groups(inner, generator, Q, h, num_reads)

            self.sampler = Log()

    monkeypatch.setattr(qbm_main, "SeedParallelDQBM", Logged)
    _, z = bands.z_all(SETTINGS)
    verdicts = {}
    for label, div in (("band", 1), ("control", bands.CONTROL_DIV)):
        calls.clear()
        bands.train_port("flat_sa_h2", tmp_path / label, device="cpu", lr_div=div)
        # one call a step (4 epochs of 10) and one validation call an epoch
        assert calls == 4 * ([tuple(_calls("flat_sa_h2")[0])] * 10
                             + [tuple(_calls("flat_sa_h2")[1])])
        verdicts[label], _ = bands.hold("flat_sa_h2", tmp_path / label, z)
    assert verdicts == {"band": True, "control": False}
    assert json.dumps(bands.widest(bands.hold("flat_sa_h2", tmp_path / "band", z)[1]))
