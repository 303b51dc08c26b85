"""The port's main path end to end on the CPU: ``qbmx_torch.cli.qbm_main``
(flat Disc_QBM, SA) on synthetic data at a small size, its flag set against
``qbmx.cli.qbm_main``, and the rule that the port imports neither jax nor
sklearn nor qbmx."""

from __future__ import annotations

import os
import pickle
import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from qbmx.cli import qbm_main as jmain
from qbmx_torch.cli import qbm_main as tmain

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
SMALL = dict(data_set="synthetic", n_hidden_nodes=2, sample_count=16, anneal=20,
             batch_size=20, epochs=1, device="cpu")


def test_main_runs_end_to_end(tmp_path, capsys):
    save = f"{tmp_path}/"
    acc, f1, precision, recall, auc = tmain.main(save=save, name="run", **SMALL)
    assert all(0.0 <= v <= 1.0 for v in (acc, f1, precision, recall, auc))
    out = capsys.readouterr().out
    assert "Epoch 1/1" in out and "Creating QBM on cpu" in out
    run = next(p for p in tmp_path.iterdir() if p.is_dir())
    weights = pickle.load(open(run / "e1.pkl", "rb"))
    # main() defaults to restricted=True: the 5-tuple without w_hh
    assert [w.shape for w in weights] == [(785, 2), (784, 1), (2,), (1,), (1, 1)]
    assert pickle.load(open(tmp_path / "runacc_auc.pkl", "rb")) == (acc, auc)
    assert (tmp_path / "run_result.txt").read_text().startswith(f"Accuracy: {acc}\n")
    assert len(pickle.load(open(tmp_path / "runnll_per_batch.pkl", "rb"))) == 30  # 600 / 20


def test_main_is_reproducible_from_its_seed():
    assert tmain.main(save="", seed=5, **SMALL) == tmain.main(save="", seed=5, **SMALL)


def _flags(parser):
    return {a.dest: (sorted(a.option_strings), a.default) for a in parser._actions}


def test_parser_has_the_reference_flags_and_defaults():
    theirs, ours = _flags(jmain.build_parser()), _flags(tmain.build_parser())
    assert ours.pop("device") == (["--device"], "cuda")
    assert ours == theirs


@pytest.mark.parametrize("kw,match", [
    (dict(solver="Advantage_system4.1"), "Ocean"),  # a QPU solver, without the Ocean SDK
    (dict(solver="FujitsuDAU"), "annealer-free"),  # refused as in qbmx
    (dict(solver="DW_2000Q_6"), "Ocean"),  # a QPU solver by its other prefix
    (dict(solver="SA-NATIVE"), None),  # ported: it runs
], ids=[f"kw{i}-NotImplementedError" for i in range(4)])
def test_unported_options_raise(kw, match):
    """Every solver string of ``qbmx`` is ported: the QPU names raise
    ``qbmx``'s guidance where the Ocean SDK is absent, and ``SA-NATIVE``
    trains."""
    if match is None:
        assert all(0.0 <= v <= 1.0 for v in tmain.main(save="", **{**SMALL, **kw}))
        return
    with pytest.raises(NotImplementedError, match=match):
        tmain.main(save="", **{**SMALL, **kw})


def test_cifar10_loads_through_the_cli(tmp_path, monkeypatch):
    """``--data_set cifar-10`` (classes 3 and 5, 32×32 grayscale) raises
    as ``qbmx`` does where the batches are absent, and trains on the
    stock-layout batches ``qbmx_torch/data/synthesize.py`` writes."""
    from qbmx_torch.data.synthesize import synthesize_cifar10

    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError):
        tmain.main(save="", **{**SMALL, "data_set": "cifar-10"})
    synthesize_cifar10(tmp_path / "data", n_per_train_batch=50, n_test=60, seed=1)
    acc, *_, auc = tmain.main(save="", **{**SMALL, "data_set": "cifar-10", "batch_size": 100})
    assert 0.0 <= acc <= 1.0 and 0.0 <= auc <= 1.0


@pytest.mark.parametrize("solver", ["BMS", "PT"])
def test_main_runs_each_solver_and_is_reproducible(solver, capsys):
    """``--solver BMS|PT`` runs end to end on the plain route and repeats
    itself from its seed."""
    kw = {**SMALL, "solver": solver, "seed": 3}
    first = tmain.main(save="", **kw)
    assert all(0.0 <= v <= 1.0 for v in first)
    assert "Epoch 1/1" in capsys.readouterr().out
    assert tmain.main(save="", **kw) == first


def test_cuda_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmain.main(save="", **{**SMALL, "device": "cuda"})


def _constructors():
    from qbmx_torch.models.cdqbm import CDQBM
    from qbmx_torch.models.dqbm import DiscQBM
    from qbmx_torch.train.sweep import SeedParallelDQBM

    return {"DiscQBM": (DiscQBM, dict(dim_input=4, n_hidden_nodes=2)),
            "CDQBM": (CDQBM, dict(image_shape=(6, 6), pooling_size=2)),
            "SeedParallelDQBM": (SeedParallelDQBM, dict(seeds=[1, 2], dim_input=4))}


@pytest.mark.parametrize("name", ["DiscQBM", "CDQBM", "SeedParallelDQBM"])
def test_models_default_to_the_card(name):
    """The model classes take the card unless asked for the CPU, as the
    CLIs do."""
    import inspect

    cls, _ = _constructors()[name]
    assert inspect.signature(cls).parameters["device"].default == "cuda"


@pytest.mark.parametrize("name", ["DiscQBM", "CDQBM", "SeedParallelDQBM"])
def test_a_model_without_a_device_never_falls_back_to_the_cpu(monkeypatch, name):
    """Built without ``device=`` on a machine without CUDA, a model raises;
    it does not carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cls, kw = _constructors()[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cls(**kw)
    assert cls(device="cpu", **kw).device == torch.device("cpu")


CDQBM_SMALL = dict(data_set="synthetic", kernel_size=20, pooling_size=3, sample_count=4,
                   anneal=3, batch_size=200, epochs=1, device="cpu",
                   pooling_type="probabilistic", save="")


def test_port_imports_no_jax_sklearn_or_qbmx():
    """In a fresh interpreter: import the port and every sampler module, run
    the flat slice with each on-device solver and a tiny CDQBM run, and find
    none of jax, sklearn or qbmx loaded."""
    code = (
        "import sys, torch; torch.set_num_threads(1)\n"
        "import qbmx_torch\n"
        "from qbmx_torch.samplers import (api, exact, gibbs, gibbs_cuda, kernel_call, pt_cuda,\n"
        "                                 pt_wide_cuda, sa_cuda, sa_torch, tempering, wide_cuda)\n"
        "from qbmx_torch.train import sweep\n"
        "from qbmx_torch import _build\n"
        "from qbmx_torch.models import cdqbm, geometry\n"
        "from qbmx_torch.data import coreset\n"
        "from qbmx_torch.cli import cdqbm_main, profile_steps, qbm_main\n"
        f"for solver in ('SA', 'BMS', 'PT'): qbm_main.main(save='', **{{**{SMALL!r}, 'solver': solver}})\n"
        f"qbm_main.main(save='', seed_sweep=[1, 2], **{SMALL!r})\n"
        f"cdqbm_main.main(**{CDQBM_SMALL!r})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'sklearn', 'qbmx'))\n"
        "print('LOADED', bad)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "LOADED []" in res.stdout


@pytest.mark.parametrize("solver", ["SA", "BMS", "PT"])
def test_profile_steps_runs_each_solver_on_cpu(solver):
    """The step profiler times every solver; the device columns stay empty
    where there is no device to profile, and the profiled epoch's spans
    count one step and one sampler call a batch and the epoch's fetches."""
    from qbmx_torch.cli import profile_steps

    (rec,) = profile_steps.main(["--device", "cpu", "--solver", solver, "--hidden", "2",
                                 "--reads", "8", "--sweeps", "4", "--batch", "200",
                                 "--epochs", "1"])
    assert rec["solver"] == solver and rec["steps"] == 3
    assert rec["ms_per_step"] > 0 and rec["epoch_ms"] == rec["epoch_ms_runs"][0]
    assert rec["kernel"] == profile_steps.SOLVER_KERNELS[solver]
    assert rec["busy_ms"] is None and rec["idle_share"] is None
    spans = rec["spans"]
    assert spans["qbmx.step"][0] == spans["qbmx.sampler"][0] == 3
    assert spans["qbmx.sync.epoch_nll"][0] == spans["qbmx.sync.epoch_err"][0] == 1
    for count, total_ms, self_ms in spans.values():
        assert count > 0 and total_ms >= self_ms >= 0
    # a step's own time leaves out its sampler call
    assert spans["qbmx.step"][2] <= spans["qbmx.step"][1] - spans["qbmx.sampler"][1] + 1e-6


@pytest.mark.parametrize("pooling,n,steps,kernel", [
    ("probabilistic", 717, 30, "anneal_wide"),
    ("deterministic", 41, 200, "sa_metropolis"),
])
def test_profile_steps_runs_each_cdqbm_config_on_cpu(pooling, n, steps, kernel):
    """The CDQBM configurations at their widths and batch sizes; the kernel
    column names the one a GPU would launch at that width."""
    from qbmx_torch.cli import profile_steps

    (rec,) = profile_steps.main(["--device", "cpu", "--solver", "SA", "--cdqbm", pooling,
                                 "--reads", "2", "--sweeps", "1", "--epochs", "1"])
    assert rec["model"] == f"CDQBM {pooling}" and rec["n"] == n and rec["steps"] == steps
    assert rec["kernel"] == kernel and rec["ms_per_step"] > 0


def test_profile_steps_runs_a_seed_sweep_on_cpu():
    """``--seed_sweep``: the sweep's step over every seed, and its share a
    seed; PT at n > 241 is K5's."""
    from qbmx_torch.cli import profile_steps

    (rec,) = profile_steps.main(["--device", "cpu", "--solver", "SA", "--hidden", "2",
                                 "--reads", "4", "--sweeps", "2", "--batch", "200",
                                 "--epochs", "1", "--seed_sweep", "1", "2", "3"])
    assert rec["model"] == "SeedParallelDQBM 3 seeds" and rec["seeds"] == 3
    assert rec["steps"] == 3 and rec["ms_per_seed_step"] == pytest.approx(rec["ms_per_step"] / 3)
    assert rec["kernel"] == "sa_metropolis" and rec["busy_ms"] is None
    assert rec["spans"]["qbmx.train"][0] == rec["spans"]["qbmx.epoch"][0] == 1
    assert rec["spans"]["qbmx.step"][0] == 3
    assert profile_steps.solver_kernel("PT", 717) == "pt_wide"
    assert profile_steps.solver_kernel("PT", 6) == "pt_heatbath"


def test_profile_steps_busy_time_is_the_union_of_spans():
    from qbmx_torch.cli.profile_steps import _union_us

    assert _union_us([(0, 2), (1, 3), (5, 6)]) == 4
    assert _union_us([(4, 5), (0, 10)]) == 10 and _union_us([]) == 0


def test_profile_steps_span_table_takes_the_inner_spans_from_self_time():
    from qbmx_torch.cli.profile_steps import span_table

    ev = lambda name, s, e: types.SimpleNamespace(name=name,
                                                  time_range=types.SimpleNamespace(start=s, end=e))
    table = span_table([ev("qbmx.step", 0, 10e3), ev("qbmx.sampler", 2e3, 6e3),
                        ev("qbmx.sync.beta_inf", 3e3, 4e3), ev("qbmx.step", 20e3, 25e3),
                        ev("aten::add", 1e3, 9e3), ev("qbmx.sampler", 21e3, 22e3)])
    assert table == {"qbmx.step": [2, 15.0, 10.0], "qbmx.sampler": [2, 5.0, 4.0],
                     "qbmx.sync.beta_inf": [1, 1.0, 1.0]}


def test_train_model_reinit_counter_persists_on_the_model():
    """Flatline recovery: a model stuck at the majority fraction is re-drawn
    with attempt 1, then 2 -- the counter lives on the model."""
    from qbmx_torch.train.loop import get_best_combined_acc_auc, train_model

    class Flat:
        seed = 0

        def __init__(self):
            self.attempts = []

        def train_epoch(self, x, y, bs, lr):
            return np.zeros(1), np.zeros(1)

        def predict_batch(self, X):
            return np.zeros(len(X), int), np.tile([1.0, 0.0], (len(X), 1))

        def reinit_params(self, attempt):
            self.attempts.append(attempt)

    m = Flat()
    X, Y = np.zeros((4, 3)), np.asarray([0, 0, 0, 1])
    h = train_model(m, X, Y, X, Y, batch_size=2, epochs=5, reinit_on_collapse=2, verbose=False)
    assert m.attempts == [1, 2] and m._reinit_attempt == 2
    assert len(h.acc_per_epoch) == 5 and get_best_combined_acc_auc(h)[0] == 0


def test_train_model_saves_crash_pickles(tmp_path):
    """A failing epoch leaves ``e<epoch>_crash.pkl`` and the history
    pickles behind, then re-raises."""
    from qbmx_torch.models.dqbm import DiscQBM
    from qbmx_torch.train.loop import train_model

    class Crashing(DiscQBM):
        def train_epoch(self, *a):
            raise RuntimeError("boom")

    m = Crashing(dim_input=4, n_hidden_nodes=2, device="cpu")
    with pytest.raises(RuntimeError, match="boom"):
        train_model(m, np.zeros((6, 4)), np.zeros(6, int), batch_size=3, epochs=2,
                    save_folder=str(tmp_path), verbose=False)
    saved = pickle.load(open(tmp_path / "e1_crash.pkl", "rb"))
    assert [w.shape for w in saved] == [(5, 2), (4, 1), (2,), (1,), (1, 1), (2, 2)]
    assert (tmp_path / "nll_per_batch.pkl").exists()


@pytest.mark.parametrize("cli", ["qbm_main", "cdqbm_main"])
@pytest.mark.parametrize("tqdm_present", [True, False])
def test_progress_draws_a_bar_over_the_batch_loop(cli, tqdm_present, capsys, monkeypatch):
    """``--progress`` reaches ``train_model`` through both CLIs and draws a
    tqdm bar over each epoch's batches (as ``qbmx`` draws one); where tqdm
    cannot be imported it is inert and the run goes on."""
    from qbmx_torch.cli import cdqbm_main as cmain

    if not tqdm_present:
        monkeypatch.setitem(sys.modules, "tqdm", None)  # import tqdm raises ImportError
    if cli == "qbm_main":
        tmain.main(save="", progress=True, **SMALL)
    else:
        cmain.main(progress=True, **CDQBM_SMALL)
    err = capsys.readouterr().err
    batches = 30 if cli == "qbm_main" else 3  # 600 synthetic images at batch 20 / 200
    bars = re.findall(r"epoch:\s+0%.*?\| 0/(\d+) ", err)
    assert bars == ([str(batches)] if tqdm_present else []), err[-500:]
