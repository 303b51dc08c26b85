"""qbmx_torch.train.sweep.SeedParallelCDQBM (the seed-parallel CDQBM sweep)
against qbmx.train.sweep.SeedParallelCDQBM at small sizes: 8×8 images,
k=3, pool 2, ``--seq_sizes 2`` (48 variables with probabilistic pooling,
12 with deterministic).

Both packages' sweeps start from the same stacked numpy parameters (3
seeds) and train one epoch of two steps (the second batch padded) with a
validation pass, each driven by a replay sampler that hands out host
variates keyed by the call's shape -- qbmx's to the TPU lane kernel in
interpret mode (constant arrays, so its jitted epoch can trace them), the
port's to the plain anneal.  Per-seed nll, parameters, accuracy and AUC
must agree within atol 1e-5 (float32 sums taken in another order).
Besides: each seed's initial parameters equal ``CDQBM(seed=s)``'s
exactly, also re-drawn; the stacked builders equal the single model's per
seed; one sampler call a step; the flatline re-draw asks the shared rule;
the best-epoch pickles load in both packages; ``cdqbm_main
--seed_sweep``'s guards raise as ``qbmx``'s do, and a CLI run writes each
seed's results.
"""

from __future__ import annotations

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qbmx.models.cdqbm as jc
import qbmx.train.sweep as jsweep
import qbmx_torch.models.cdqbm as tc
import qbmx_torch.train.sweep as tsweep
from qbmx.cli import cdqbm_main as jmain
from qbmx.samplers.sa_lane import lane_sample_groups
from qbmx_torch.cli import cdqbm_main as tmain
from qbmx_torch.samplers import sa_torch

torch.set_num_threads(1)
SEEDS = [3, 7, 11]
B, R, SWEEPS, CHUNK = 4, 8, 5, 32
N_TRAIN, N_VAL = 7, 6  # two steps of 4, the second padded; one validation chunk of 32
BASE = dict(image_shape=(8, 8), kernel_size=3, pooling_size=2, sequential_layer_sizes=[2],
            sample_count=R, anneal=SWEEPS)


def _variates(n, S, chunk=CHUNK):
    """Host variates keyed by the sampler call's (groups, problems): the
    training steps' 2·S groups of B, a validation chunk's S groups of
    ``chunk``."""
    rng = np.random.default_rng(31)
    return {(g, b): ((rng.random((g, b, R, n)) < 0.5).astype(np.float32),
                     np.clip(rng.random((SWEEPS, g, b, n, R)), 1e-6, 1 - 1e-6)
                     .astype(np.float32))
            for g, b in ((2 * S, B), (S, chunk))}


class _JaxReplay:
    """qbmx sampler: the TPU lane kernel in interpret mode on the variates
    of the call's shape, as constants (jit-safe: qbmx's sweep traces it)."""

    def __init__(self, variates):
        self.variates = variates

    def sample_groups(self, key, Q_shared, h_extra, num_reads):
        init01, u = self.variates[tuple(h_extra.shape[:2])]
        return lane_sample_groups(key, Q_shared, h_extra, num_reads, SWEEPS, rule="metropolis",
                                  interpret=True,
                                  debug_randoms=(jnp.asarray(init01), jnp.asarray(u)))


class _TorchReplay:
    def __init__(self, variates, calls=None):
        self.variates, self.calls = variates, calls

    def sample_groups(self, generator, Q_shared, h_extra, num_reads):
        if self.calls is not None:
            self.calls.append(tuple(h_extra.shape))
        init01, u = self.variates[tuple(h_extra.shape[:2])]
        return sa_torch.sa_sample_groups_plain(
            Q_shared, h_extra, num_reads, SWEEPS,
            host_variates=(torch.as_tensor(init01), torch.as_tensor(u)))


def _leaves(p) -> dict:
    """name → numpy array for every tensor of a params tree of either package."""
    out = {}
    for f in dataclasses.fields(p):
        v = getattr(p, f.name)
        if isinstance(v, tuple):
            out.update({f"{f.name}[{i}]": np.asarray(w) for i, w in enumerate(v)})
        elif v is not None:
            out[f.name] = np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
    return out


def _data(num_classes=2):
    rng = np.random.default_rng(12)
    x = rng.random((N_TRAIN, 8, 8), dtype=np.float32)
    xv = rng.random((N_VAL, 8, 8), dtype=np.float32)
    return x, rng.integers(0, num_classes, N_TRAIN), xv, np.asarray([0, 1, 1, 0, 1, 0])


CASES = {
    "deterministic": dict(pooling_type="deterministic"),
    "probabilistic": dict(pooling_type="probabilistic", grad_clip=0.5),
    "probabilistic per-unit restricted": dict(pooling_type="probabilistic",
                                              hidden_bias_type="per-unit", is_restricted=True,
                                              learn_penalty=True),
    "deterministic none": dict(pooling_type="deterministic", hidden_bias_type="none"),
}


def _models(kw, variates=None, **extra):
    """(qbmx donor, port donor) of one configuration, each with its replay
    sampler when ``variates`` are given."""
    js = None if variates is None else _JaxReplay(variates)
    ts = None if variates is None else _TorchReplay(variates, **extra)
    return (jc.CDQBM(sampler=js, **{**BASE, **kw}),
            tc.CDQBM(sampler=ts, device="cpu", **{**BASE, **kw}))


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_epoch_and_validation_match(case):
    kw = CASES[case]
    jm, _ = _models(kw)
    variates = _variates(jm.geo.n_total, len(SEEDS))
    jm, tm = _models(kw, variates)
    js, ts = jsweep.SeedParallelCDQBM(SEEDS, jm), tsweep.SeedParallelCDQBM(SEEDS, tm)
    ts.params = tc.params_from_numpy(js.params)  # the same stacked numpy parameters
    x, y, xv, yv = _data()
    train = dict(epochs=1, batch_size=B, learning_rate=0.3, verbose=False)
    jh, th = js.train(x, y, xv, yv, **train), ts.train(x, y, xv, yv, **train)
    for s in range(len(SEEDS)):
        assert len(th[s].nll_per_batch) == 2
        for series in ("nll_per_batch", "acc_per_epoch", "auc_per_epoch", "prob_auc_per_epoch"):
            np.testing.assert_allclose(getattr(th[s], series), getattr(jh[s], series),
                                       rtol=0, atol=1e-5, err_msg=f"seed {s} {series}")
    got, want = _leaves(ts.params), _leaves(js.params)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].shape[0] == len(SEEDS)
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)
    assert list(ts.best_epoch) == list(js.best_epoch) == [1, 1, 1]


@pytest.mark.parametrize("chunk", [7, 4])
def test_predict_chunk_matches_qbmx(chunk):
    """``train(predict_chunk=...)`` as in ``qbmx``: validation in chunks of
    ``chunk`` examples (6 examples: one padded chunk of 7, or 4 + 2 padded),
    the same accuracy, AUC and probability AUC per seed."""
    kw = CASES["probabilistic"]
    jm, _ = _models(kw)
    variates = _variates(jm.geo.n_total, len(SEEDS), chunk)
    calls = []
    jm, tm = _models(kw, variates, calls=calls)
    js, ts = jsweep.SeedParallelCDQBM(SEEDS, jm), tsweep.SeedParallelCDQBM(SEEDS, tm)
    ts.params = tc.params_from_numpy(js.params)
    x, y, xv, yv = _data()
    train = dict(epochs=1, batch_size=B, learning_rate=0.3, verbose=False,
                 predict_chunk=chunk)
    jh, th = js.train(x, y, xv, yv, **train), ts.train(x, y, xv, yv, **train)
    assert calls[2:] == [(len(SEEDS), chunk, jm.geo.n_total)] * -(-N_VAL // chunk)
    for s in range(len(SEEDS)):
        for series in ("acc_per_epoch", "auc_per_epoch", "prob_auc_per_epoch"):
            np.testing.assert_allclose(getattr(th[s], series), getattr(jh[s], series),
                                       rtol=0, atol=1e-5, err_msg=f"seed {s} {series}")


def test_stacked_params_cross_from_qbmx():
    """A stacked ``qbmx`` ``CDQBMParams`` fetched to numpy, seed axis first,
    goes to the port and back unchanged."""
    jm, _ = _models(CASES["probabilistic per-unit restricted"])
    js = jsweep.SeedParallelCDQBM(SEEDS, jm)
    p = tc.params_from_numpy(js.params)
    assert p.kernel.shape == (3, 1, 3, 3) and p.pen.shape[0] == 3
    back = tc.params_to_numpy(p)
    want = _leaves(js.params)
    assert all(np.array_equal(v, want[k]) for k, v in _leaves(tc.params_from_numpy(back)).items())


@pytest.mark.parametrize("case", sorted(CASES))
def test_stacked_builders_equal_the_single_models(case):
    """The step's QUBOs and moments with stacked parameters are each seed's
    single-model ones (float32 sums in another order: atol 1e-6)."""
    _, tm = _models(CASES[case])
    sw = tsweep.SeedParallelCDQBM(SEEDS, tm)
    x, y, _, _ = _data()
    x, y = torch.as_tensor(x[:B]), torch.as_tensor(y[:B])
    lv = tm._label_vec(y)
    Q, h = sw.step_qubos(x, y)
    S, nh = len(SEEDS), tm.geo.n_hidden
    assert Q.shape == (2 * S, tm.geo.n_total, tm.geo.n_total) and h.shape[:2] == (2 * S, B)
    rng = np.random.default_rng(5)
    s = torch.as_tensor((rng.random((S, B, R, tm.geo.n_total)) < 0.5).astype(np.float32))
    ctx = tm._context(sw.params, x)
    mc, mu = tm._moments(sw.params, s[..., :nh], ctx, lv), tm._moments(sw.params, s, ctx)
    for i in range(S):
        p = sw.params_for_seed(i)
        Q1, h1 = tm.step_qubos(p, x, lv)
        np.testing.assert_allclose(Q[[i, S + i]], Q1, rtol=0, atol=1e-6)
        np.testing.assert_allclose(h[[i, S + i]], h1, rtol=0, atol=1e-6)
        c1 = tm._context(p, x)
        for got, want in ((mc, tm._moments(p, s[i, ..., :nh], c1, lv)),
                          (mu, tm._moments(p, s[i], c1))):
            for k, v in _leaves(tc.tree_map(lambda a: a[i], got)).items():
                np.testing.assert_allclose(v, _leaves(want)[k], rtol=1e-5, atol=1e-6,
                                           err_msg=k)


def test_each_seed_starts_where_a_single_model_does():
    """Seed s's initial parameters are ``CDQBM(seed=s)``'s, bit for bit, and
    a re-drawn seed's are ``reinit_params(attempt)``'s; the other seeds
    keep theirs."""
    kw = {**BASE, **CASES["probabilistic per-unit restricted"]}
    sw = tsweep.SeedParallelCDQBM(SEEDS, tc.CDQBM(seed=99, device="cpu", **kw))
    singles = [tc.CDQBM(seed=s, device="cpu", **kw) for s in SEEDS]

    def check():
        for i, m in enumerate(singles):
            got, want = _leaves(sw.params_for_seed(i)), _leaves(m.params)
            assert got.keys() == want.keys()
            assert all(np.array_equal(got[k], want[k]) for k in got)

    check()
    sw.reinit_seeds([1], attempt=1)
    singles[1].reinit_params(attempt=1)
    check()


@pytest.mark.parametrize("case", ["deterministic", "probabilistic per-unit restricted"])
def test_each_seed_starts_where_qbmx_does(case):
    """The sweep's initial parameters are ``qbmx``'s sweep's, bit for bit,
    and so are a re-drawn seed's."""
    kw = {**BASE, **CASES[case]}
    ts = tsweep.SeedParallelCDQBM(SEEDS, tc.CDQBM(seed=99, device="cpu", **kw))
    js = jsweep.SeedParallelCDQBM(SEEDS, jc.CDQBM(seed=99, **kw))

    def check():
        for i in range(len(SEEDS)):
            got = _leaves(ts.params_for_seed(i))
            want = _leaves(jax.tree.map(lambda a: a[i], js.params))
            assert got.keys() == want.keys()
            for k in got:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    check()
    ts.reinit_seeds([1], attempt=1)
    js.reinit_seeds([1], attempt=1)
    check()


def test_one_sampler_call_a_step():
    """A step is ONE structured call of 2·S groups (clamped first, padded to
    n_total), a validation chunk one call of S groups of 32."""
    calls = []
    jm, _ = _models(CASES["deterministic"])
    n = jm.geo.n_total
    _, tm = _models(CASES["deterministic"], _variates(n, len(SEEDS)), calls=calls)
    sw = tsweep.SeedParallelCDQBM(SEEDS, tm)
    x, y, xv, yv = _data()
    sw.train(x, y, xv, yv, epochs=1, batch_size=B, verbose=False)
    assert calls == [(6, B, n)] * 2 + [(3, CHUNK, n)]


def test_flatlined_seeds_are_redrawn_with_the_shared_rule(monkeypatch):
    """Every N epochs the seeds that ``train.loop.flatlined`` finds are
    re-drawn at their next attempt; never after the last epoch."""
    asked = []
    monkeypatch.setattr(tsweep, "flatlined",
                        lambda accs, vy, w: asked.append(len(accs)) or len(asked) % 3 == 2)
    _, tm = _models(dict(CASES["deterministic"], sample_count=2, anneal=2))
    sw = tsweep.SeedParallelCDQBM(SEEDS, tm)
    redrawn = []
    monkeypatch.setattr(sw, "reinit_seeds", lambda idx, attempt: redrawn.append((idx, attempt)))
    x, y, xv, yv = _data()
    sw.train(x, y, xv, yv, epochs=3, batch_size=B, verbose=False, reinit_on_collapse=1)
    assert asked == [1, 1, 1, 2, 2, 2]  # after epochs 1 and 2, not 3
    assert redrawn == [([1], 1), ([1], 2)]


@pytest.mark.parametrize("case", ["deterministic", "probabilistic per-unit restricted"])
def test_best_model_pickles_cross_load(tmp_path, case):
    """The port's best-epoch pickles (8 entries, 9 with learned penalties)
    load into both packages' CDQBM, and qbmx's sweep pickles into the
    port's."""
    kw = {**BASE, **CASES[case], "sample_count": 2, "anneal": 2}
    x, y, xv, yv = _data()
    ts = tsweep.SeedParallelCDQBM(SEEDS, tc.CDQBM(device="cpu", **kw))
    ts.train(x, y, xv, yv, epochs=2, batch_size=B, verbose=False)
    paths = ts.save_best_models(tmp_path / "torch")
    assert sorted(paths) == SEEDS
    for i, s in enumerate(SEEDS):
        want = _leaves(ts.best_params_for_seed(i))
        assert f"_se{s}_e{ts.best_epoch[i]}_best.pkl" in paths[s]
        assert len(pickle.load(open(paths[s], "rb"))) == (9 if kw.get("learn_penalty") else 8)
        for m in (tc.CDQBM(load_path=paths[s], device="cpu", **kw),
                  jc.CDQBM(load_path=paths[s], **kw)):
            got = _leaves(m.params)
            assert got.keys() == want.keys()
            assert all(np.array_equal(got[k], want[k]) for k in got)
    js = jsweep.SeedParallelCDQBM(SEEDS, jc.CDQBM(**kw))
    js.train(x, y, xv, yv, epochs=1, batch_size=B, verbose=False)
    for i, path in enumerate(js.save_best_models(tmp_path / "jax").values()):
        got, want = _leaves(tc.CDQBM(load_path=path, device="cpu", **kw).params), \
            _leaves(js.best_params_for_seed(i))
        assert all(np.array_equal(got[k], want[k]) for k in want)


SMALL = dict(data_set="synthetic", kernel_size=20, pooling_size=3, sample_count=2, anneal=2,
             batch_size=200, epochs=1, pooling_type="probabilistic")


@pytest.mark.parametrize("kw,match", [
    (dict(seed_sweep=[1, 2], resume="state.npz"), "--resume/--checkpoint_every need"),
    (dict(seed_sweep=[1, 2], checkpoint_every=1), "--resume/--checkpoint_every need"),
    (dict(seed_sweep=[1, 2], coreset_budget=10), "does not compose with --coreset_budget"),
    (dict(reinit_on_collapse=1), "requires --seed_sweep"),
])
def test_seed_sweep_guards_raise_as_in_qbmx(kw, match):
    for main, extra in ((jmain.main, {}), (tmain.main, {"device": "cpu"})):
        with pytest.raises(ValueError, match=match):
            main(save="", **SMALL, **kw, **extra)


def test_cdqbm_main_seed_sweep_writes_per_seed_results(tmp_path, capsys):
    """``cdqbm_main --seed_sweep`` on the CPU: one batched sweep, per-seed
    acc/auc pickles, one best-epoch pickle a seed that loads back."""
    accs, aucs = tmain.main(save=f"{tmp_path}/", name="sw", seed_sweep=[5, 6], device="cpu",
                            reinit_on_collapse=1, **SMALL)
    assert len(accs) == len(aucs) == 2 and all(0.0 <= a <= 1.0 for a in accs + aucs)
    out = capsys.readouterr().out
    assert "MEAN acc" in out and "seed 5: best acc" in out
    for s in (5, 6):
        assert len(pickle.load(open(tmp_path / f"swacc_per_epoch{s}.pkl", "rb"))) == 1
    pkls = sorted((tmp_path / "best_model").glob("sw_se*_e1_best.pkl"))
    assert len(pkls) == 2
    tc.CDQBM(kernel_size=20, pooling_size=3, pooling_type="probabilistic",
             sequential_layer_sizes=[4], load_path=str(pkls[0]), device="cpu")


def test_profile_steps_runs_a_cdqbm_seed_sweep_on_cpu():
    """``profile_steps --seed_sweep ... --cdqbm``: the CDQBM sweep's step at
    the configuration's width and batch, and its share a seed."""
    from qbmx_torch.cli import profile_steps

    (rec,) = profile_steps.main(["--device", "cpu", "--solver", "SA", "--cdqbm",
                                 "probabilistic", "--reads", "2", "--sweeps", "1", "--epochs",
                                 "1", "--seed_sweep", "1", "2"])
    assert rec["model"] == "SeedParallelCDQBM 2 seeds (CDQBM probabilistic)"
    assert rec["n"] == 717 and rec["steps"] == 30 and rec["seeds"] == 2
    assert rec["kernel"] == "anneal_wide" and rec["busy_ms"] is None
    assert rec["ms_per_seed_step"] == pytest.approx(rec["ms_per_step"] / 2)
