"""qbmx_torch.train.sweep.SeedParallelRBM and qbmx_torch.cli.rbm_main against
qbmx's at small sizes.

Both sweeps start from the same stacked parameters (``qbmx``'s, carried
across as numpy) and train discriminatively without shuffling, where no
random number is drawn: per-seed accuracy and AUC lists must be equal, and
the parameters and the best-epoch parameters agree within 1e-4 (float32
products summed in another order over 4 epochs).  The stacked CD step of
the sweep equals each seed's single-model step under the same variates
within 1e-6.  Besides: each seed starts where ``ClassificationRBM(seed=s)``
does, the refusals and the cumulative best epoch follow ``qbmx``, the
best-epoch pickles load in both packages, and ``rbm_main`` has
``qbmx``'s flags (plus ``--device``), guards and outputs.
"""

from __future__ import annotations

import argparse
import os
import pickle
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

import qbmx.models.rbm as jr
import qbmx.train.sweep as jsweep
import qbmx_torch.models.rbm as tr
import qbmx_torch.train.sweep as tsweep
from qbmx.cli import rbm_main as jmain
from qbmx_torch.cli import rbm_main as tmain

torch.set_num_threads(1)
FIELDS = tr.FIELDS
SEEDS = [3, 7, 11]
V, H = 8, 3


def _data(seed, n, V=V):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, n)
    base = rng.uniform(0, 1, (2, V))
    x = ((0.6 * base[y] + 0.4 * rng.uniform(0, 1, (n, V))) > 0.5).astype(np.float32)
    return x, y


def _jnp_fields(p):
    return {k: np.asarray(getattr(p, k), np.float32) for k in FIELDS}


def _pair(**kw):
    js = jsweep.SeedParallelRBM(SEEDS, V, H, learning_rate=0.2, **kw)
    ts = tsweep.SeedParallelRBM(SEEDS, V, H, learning_rate=0.2, device="cpu", **kw)
    ts.params = tr.params_from_numpy(_jnp_fields(js.params))
    return js, ts


@pytest.mark.parametrize("n,batch", [(48, 12), (50, 12)], ids=["whole", "ragged tail dropped"])
def test_sweep_matches_qbmx(n, batch):
    x, y = _data(0, n)
    tx, ty = _data(1, 30)
    js, ts = _pair()
    jacc, jauc = js.sweep(x, y, tx, ty, epochs=4, batch_size=batch, shuffle=False)
    tacc, tauc = ts.sweep(x, y, tx, ty, epochs=4, batch_size=batch, shuffle=False)
    assert tacc == jacc
    np.testing.assert_allclose(tauc, jauc, atol=1e-12)
    for got, want in ((ts.params, js.params), (ts.best_params, js.best_params)):
        for k in FIELDS:
            np.testing.assert_allclose(tr.params_to_numpy(got)[k], _jnp_fields(want)[k],
                                       rtol=0, atol=1e-4, err_msg=k)
    np.testing.assert_array_equal(ts.best_epoch, js.best_epoch)
    np.testing.assert_allclose(ts.best_metric, js.best_metric, atol=1e-12)


def test_each_seed_starts_where_a_single_model_does():
    ts = tsweep.SeedParallelRBM(SEEDS, V, H, device="cpu")
    for i, s in enumerate(SEEDS):
        single = tr.ClassificationRBM(V, H, seed=s, device="cpu")
        for k in FIELDS:
            assert torch.equal(getattr(ts.params_for_seed(i), k), getattr(single.params, k))


@pytest.mark.parametrize("method", ["generative", "hybrid"])
def test_stacked_step_is_each_seeds_step(method):
    """The sweep's batched step over (S, B, ...) equals the single model's
    step per seed, under the same CD variates."""
    rng = np.random.default_rng(2)
    S, B, C = 3, 6, 2
    params = tr.params_from_numpy({k: rng.normal(size=shape).astype(np.float32) for k, shape in
                                   zip(FIELDS, ((S, V, H), (S, V), (S, H), (S, C), (S, C, H)))})
    x = (rng.random((S, B, V)) > 0.5).astype(np.float32)
    y = rng.integers(0, C, (S, B))
    variates = [rng.random((S, B, H)).astype(np.float32)]
    step = tr.make_train_step(C, method=method, generative_factor=0.5)
    new, loss = step(params, torch.as_tensor(x), torch.as_tensor(y), 0.1, variates=variates)
    assert loss.shape == (S,)
    for s in range(S):
        one = tr.RBMParams(*(getattr(params, k)[s] for k in FIELDS))
        want, wloss = step(one, torch.as_tensor(x[s]), torch.as_tensor(y[s]), 0.1,
                           variates=[variates[0][s]])
        assert float(loss[s]) == pytest.approx(float(wloss), rel=1e-6)
        for k in FIELDS:
            np.testing.assert_allclose(getattr(new, k)[s].numpy(), getattr(want, k).numpy(),
                                       rtol=1e-6, atol=1e-6, err_msg=k)


def test_generative_sweep_trains_and_shuffles():
    x, y = _data(3, 48)
    ts = tsweep.SeedParallelRBM([0, 1], V, 4, learning_rate=0.2, method="generative",
                                device="cpu")
    before = ts.params.weights.clone()
    accs, aucs = ts.sweep(x, y, x, y, epochs=2, batch_size=12)
    assert len(accs) == 2 and len(accs[0]) == 2 and len(aucs[1]) == 2
    assert not torch.equal(before, ts.params.weights)


def test_refusals():
    with pytest.raises(ValueError, match="pcd"):
        tsweep.SeedParallelRBM([0], V, H, method="pcd", device="cpu")
    x, y = _data(4, 24)
    ts = tsweep.SeedParallelRBM([0], V, H, device="cpu")
    with pytest.raises(ValueError, match="batch_size"):
        ts.sweep(x, y, x, y, epochs=1, batch_size=100)
    with pytest.raises(RuntimeError, match="sweep"):
        ts.best_params_for_seed(0)


def test_best_epoch_is_cumulative_across_sweep_calls():
    """A winner of a second ``sweep()`` call records its total epoch."""
    x, y = _data(5, 48)
    tx, ty = _data(6, 20)
    ts = tsweep.SeedParallelRBM([11, 12], V, H, learning_rate=0.2, device="cpu")
    acc1, auc1 = ts.sweep(x, y, tx, ty, epochs=2, batch_size=12)
    acc2, auc2 = ts.sweep(x, y, tx, ty, epochs=2, batch_size=12)
    for s in range(2):
        comb1 = 0.5 * np.asarray(acc1[s]) + 0.5 * np.asarray(auc1[s])
        comb2 = 0.5 * np.asarray(acc2[s]) + 0.5 * np.asarray(auc2[s])
        e1, e2 = int(np.argmax(comb1)), int(np.argmax(comb2))
        expect = 2 + e2 + 1 if comb2[e2] > comb1[e1] else e1 + 1
        assert ts.best_epoch[s] == expect
        assert ts.best_metric[s] == max(comb1[e1], comb2[e2])


def test_best_model_pickles_load_both_ways(tmp_path):
    """The port's winners reload in both packages and reproduce their
    best-epoch accuracy exactly (exact p(y|x)); ``qbmx``'s load in the port."""
    x, y = _data(7, 48)
    tx, ty = _data(8, 20)
    ts = tsweep.SeedParallelRBM([11, 12], V, H, learning_rate=0.2, device="cpu")
    accs, _ = ts.sweep(x, y, tx, ty, epochs=3, batch_size=12)
    paths = ts.save_best_models(tmp_path / "port")
    for i, s in enumerate([11, 12]):
        for rbm in (jr.ClassificationRBM(V, H), tr.ClassificationRBM(V, H, device="cpu")):
            rbm.load_params(paths[s])
            acc, _ = rbm.run_test_set(tx, ty)
            assert acc == pytest.approx(accs[i][int(ts.best_epoch[i]) - 1], abs=1e-12)
        got = tr.params_to_numpy(ts.best_params_for_seed(i))
        with open(paths[s], "rb") as f:
            for k, a in zip(FIELDS, pickle.load(f), strict=True):
                np.testing.assert_array_equal(a, got[k])
    js = jsweep.SeedParallelRBM([5], V, H, learning_rate=0.2)
    js.sweep(x, y, tx, ty, epochs=2, batch_size=12)
    (jpath,) = js.save_best_models(tmp_path / "jax").values()
    rbm = tr.ClassificationRBM(V, H, device="cpu")
    rbm.load_params(jpath)
    for k, a in _jnp_fields(js.best_params_for_seed(0)).items():
        np.testing.assert_array_equal(tr.params_to_numpy(rbm.params)[k], a)


# -- rbm_main -----------------------------------------------------------------


def _flags(parser):
    return {a.dest: (sorted(a.option_strings), a.default) for a in parser._actions}


def test_parser_has_qbmx_flags_and_defaults():
    theirs, ours = _flags(jmain.build_parser()), _flags(tmain.build_parser())
    assert ours.pop("device") == (["--device"], "cuda")
    assert ours == theirs
    assert tmain.DEFAULT_SEEDS == jmain.DEFAULT_SEEDS


def _args(tmp_path, *extra):
    return tmain.build_parser().parse_args(
        ["--data_set", "synthetic", "--epochs", "1", "--out", str(tmp_path), "--device", "cpu",
         *extra])


@pytest.mark.parametrize("extra,match", [
    (["--seed_parallel", "--resume", "s.npz"], "sequential path"),
    (["--seed_parallel", "--checkpoint_every", "1"], "sequential path"),
    (["--resume", "s.npz", "--seeds", "1", "2"], "exactly one"),
])
def test_guards_raise_as_in_qbmx(tmp_path, extra, match):
    for mod in (tmain, jmain):
        args = _args(tmp_path, *extra)
        if mod is jmain:
            args = argparse.Namespace(**{k: v for k, v in vars(args).items() if k != "device"})
        with pytest.raises(ValueError, match=match):
            mod.main(args)


def test_cuda_without_a_gpu_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _args(tmp_path, "--seeds", "1")
    args.device = "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmain.main(args)


@pytest.mark.parametrize("parallel", [False, True], ids=["sequential", "seed_parallel"])
def test_one_synthetic_epoch_through_the_cli(tmp_path, capsys, parallel):
    args = _args(tmp_path, "--seeds", "4", "5", *(["--seed_parallel"] if parallel else []))
    results = tmain.main(args)
    out = capsys.readouterr().out
    assert len(results) == 2 and all(0.0 <= r <= 1.0 for r in results)
    assert "mean best-epoch acc over 2 seeds" in out
    for s in (4, 5):
        for name in ("acc", "auc"):
            with open(tmp_path / f"{name}_per_epoch{s}.pkl", "rb") as f:
                assert len(pickle.load(f)) == 1
    assert (tmp_path / "best_model").is_dir() == parallel


def test_profile_steps_rbm_rows_on_cpu(monkeypatch):
    """``profile_steps --rbm``: the CD-1 bf16 rows at both widths and the
    ``rbm_main`` defaults single and as a 10-seed sweep (the headline's
    65,536 images cut to 512 here); no device columns on the CPU."""
    from qbmx_torch.cli import profile_steps

    monkeypatch.setattr(profile_steps, "RBM_IMAGES", 512)
    monkeypatch.setattr(profile_steps, "RBM_BATCH", 128)
    recs = profile_steps.main(["--rbm", "--device", "cpu", "--epochs", "1"])
    assert [r["model"].split(" ")[0] for r in recs] == ["RBM", "RBM", "ClassificationRBM",
                                                        "SeedParallelRBM"]
    assert "H=128" in recs[0]["model"] and "H=9" in recs[1]["model"]
    assert [r["steps"] for r in recs] == [4, 4, 86, 85]  # 600 synthetic images at batch 7
    for r in recs:
        assert r["images_per_s"] > 0 and r["idle_share"] is None


def test_the_rbm_path_imports_neither_jax_nor_qbmx():
    """The RBM modules, the warm start and the data helpers run in a process
    that loads no jax, scikit-learn or ``qbmx`` module."""
    root = Path(__file__).resolve().parent.parent
    code = (
        "import sys, numpy as np\n"
        "from qbmx_torch.cli import rbm_main\n"
        "from qbmx_torch.models import rbm, warmstart\n"
        "from qbmx_torch.data import loaders\n"
        "args = rbm_main.build_parser().parse_args(['--data_set', 'synthetic', '--epochs', '1',\n"
        "    '--device', 'cpu', '--seeds', '1', '--out', sys.argv[1]])\n"
        "rbm_main.main(args)\n"
        "m = rbm.ClassificationRBM(16, 2, device='cpu')\n"
        "warmstart.warm_start_dqbm(m, seed=0)\n"
        "x = np.random.default_rng(0).random((8, 6, 6)).astype('float32')\n"
        "loaders.preprocess_images(x, x, outputshape=(3, 3), pca_n_components=2)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'sklearn', 'qbmx'))\n"
        "print('LOADED', bad)\n"
    )
    with tempfile.TemporaryDirectory() as tmp:
        res = subprocess.run([sys.executable, "-c", code, tmp], capture_output=True, text=True,
                             cwd=root, env={**os.environ, "PYTHONPATH": str(root)}, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "LOADED []" in res.stdout
