"""qbmx_torch.train.sweep (the seed-parallel flat Disc_QBM sweep) against
qbmx.train.sweep at small sizes.

The slice: both packages' ``SeedParallelDQBM`` start from the same stacked
numpy parameters (3 seeds) and train one epoch of two steps (the second
batch padded) with a validation pass, each driven by a replay sampler that
hands out host variates keyed by the call's shape -- qbmx's to the TPU lane
kernel in interpret mode (constant arrays, so its jitted epoch can trace
it), the port's to the plain anneal.  Per-seed nll, parameters, accuracy
and AUC must agree within atol 1e-5 (float32 moments summed in another
order).  Besides: each seed's initial parameters equal ``DiscQBM(seed=s)``'s
exactly, also re-drawn; the best-epoch pickles load in both packages, and
the committed flagship pickles in the port; the ``--seed_sweep`` guards of
``qbm_main`` raise as ``qbmx``'s do.
"""

from __future__ import annotations

import glob
import pickle
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qbmx.models.dqbm as jd
import qbmx.train.sweep as jsweep
import qbmx_torch.models.dqbm as td
import qbmx_torch.train.sweep as tsweep
from qbmx.cli import qbm_main as jmain
from qbmx.samplers.sa_lane import lane_sample_groups
from qbmx_torch.cli import qbm_main as tmain
from qbmx_torch.samplers import sa_torch

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
FIELDS = td.FIELDS
SEEDS = [3, 7, 11]
D, H, B, R, SWEEPS = 10, 3, 4, 8, 5
N_TRAIN, N_VAL = 7, 6  # two steps of 4, the second padded; one validation call


def _variates(n_u, S):
    """Host variates keyed by the sampler call's (groups, problems): the
    training steps' 2·S groups of B, the validation call's S groups of
    N_VAL."""
    rng = np.random.default_rng(31)
    return {(g, b): ((rng.random((g, b, R, n_u)) < 0.5).astype(np.float32),
                     np.clip(rng.random((SWEEPS, g, b, n_u, R)), 1e-6, 1 - 1e-6)
                     .astype(np.float32))
            for g, b in ((2 * S, B), (S, N_VAL))}


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
    def __init__(self, variates):
        self.variates = variates

    def sample_groups(self, generator, Q_shared, h_extra, num_reads):
        init01, u = self.variates[tuple(h_extra.shape[:2])]
        return sa_torch.sa_sample_groups_plain(
            Q_shared, h_extra, num_reads, SWEEPS,
            host_variates=(torch.as_tensor(init01), torch.as_tensor(u)))


def _stacked_params(O, restricted):
    rng = np.random.default_rng(8)
    u = lambda *s: rng.uniform(-1, 1, (len(SEEDS),) + s).astype(np.float32)
    return dict(w_vh=u(O + D, H), w_vo=u(D, O), w_oo=np.triu(u(O, O), 1), b_h=u(H), b_o=u(O),
                w_hh=(np.zeros((len(SEEDS), H, H), np.float32) if restricted
                      else np.triu(u(H, H), 1)))


def _data(one_hot):
    rng = np.random.default_rng(12)
    x, xv = rng.random((N_TRAIN, D)).astype(np.float32), rng.random((N_VAL, D)).astype(np.float32)
    return x, rng.integers(0, 2, N_TRAIN), xv, np.asarray([0, 1, 1, 0, 1, 0])


@pytest.mark.parametrize("one_hot,restricted,grad_clip", [
    (False, False, 0.0),
    (True, False, 0.5),
    (False, True, 0.0),
])
def test_one_epoch_and_validation_match(one_hot, restricted, grad_clip):
    O = 2 if one_hot else 1
    variates = _variates(O + H, len(SEEDS))
    kw = dict(dim_input=D, n_hidden_nodes=H, sample_count=R, anneal_steps=SWEEPS,
              restricted=restricted, use_one_hot_encoding=one_hot, grad_clip=grad_clip)
    js = jsweep.SeedParallelDQBM(SEEDS, sampler=_JaxReplay(variates), **kw)
    ts = tsweep.SeedParallelDQBM(SEEDS, sampler=_TorchReplay(variates), device="cpu", **kw)
    d = _stacked_params(O, restricted)
    js.params = jd.DQBMParams(**{k: jnp.asarray(v) for k, v in d.items()})
    ts.params = tsweep.sweep_params_from_numpy(d)
    x, y, xv, yv = _data(one_hot)
    train = dict(epochs=1, batch_size=B, learning_rate=0.3, verbose=False)
    jh, th = js.train(x, y, xv, yv, **train), ts.train(x, y, xv, yv, **train)
    for s in range(len(SEEDS)):
        assert len(th[s].nll_per_batch) == 2
        for series in ("nll_per_batch", "acc_per_epoch", "auc_per_epoch", "prob_auc_per_epoch"):
            np.testing.assert_allclose(getattr(th[s], series), getattr(jh[s], series),
                                       rtol=0, atol=1e-5, err_msg=series)
    got = tsweep.sweep_params_to_numpy(ts.params)
    for k in FIELDS:
        np.testing.assert_allclose(got[k], np.asarray(getattr(js.params, k)), rtol=0, atol=1e-5,
                                   err_msg=k)
    assert list(ts.best_epoch) == list(js.best_epoch) == [1, 1, 1]


def test_sweep_params_round_trip():
    d = _stacked_params(1, False)
    p = tsweep.sweep_params_from_numpy(d)
    assert p.w_vh.shape == (len(SEEDS), 1 + D, H) and p.w_vh.dtype == torch.float32
    back = tsweep.sweep_params_to_numpy(p)
    assert all(np.array_equal(back[k], d[k]) for k in FIELDS)


def test_each_seed_starts_where_a_single_model_does():
    """Seed s's initial parameters are ``DiscQBM(seed=s)``'s, bit for bit,
    and a re-drawn seed's are ``reinit_params(attempt)``'s; the other
    seeds keep theirs."""
    kw = dict(dim_input=D, n_hidden_nodes=H, restricted=False)
    sw = tsweep.SeedParallelDQBM(SEEDS, device="cpu", **kw)
    singles = [td.DiscQBM(seed=s, device="cpu", **kw) for s in SEEDS]
    for i, m in enumerate(singles):
        got = td.params_to_numpy(sw.params_for_seed(i))
        assert all(np.array_equal(got[k], v) for k, v in td.params_to_numpy(m.params).items())
    sw.reinit_seeds([1], attempt=1)
    singles[1].reinit_params(attempt=1)
    for i, m in enumerate(singles):
        got = td.params_to_numpy(sw.params_for_seed(i))
        assert all(np.array_equal(got[k], v) for k, v in td.params_to_numpy(m.params).items())


@pytest.mark.parametrize("restricted", [False, True])
def test_each_seed_starts_where_qbmx_does(restricted):
    """The sweep's initial parameters are ``qbmx``'s sweep's, bit for bit,
    and so are a re-drawn seed's: the two packages' seed bands differ only
    in the samplers' draws."""
    seeds = list(range(10))
    kw = dict(dim_input=D, n_hidden_nodes=8, restricted=restricted)
    ts, js = tsweep.SeedParallelDQBM(seeds, device="cpu", **kw), jsweep.SeedParallelDQBM(seeds,
                                                                                         **kw)

    def check():
        got = tsweep.sweep_params_to_numpy(ts.params)
        for k in FIELDS:
            np.testing.assert_array_equal(got[k], np.asarray(getattr(js.params, k)), err_msg=k)

    check()
    ts.reinit_seeds([1, 4], attempt=2)
    js.reinit_seeds([1, 4], attempt=2)
    check()


def test_one_sampler_call_a_step():
    """A step is ONE structured call of 2·S groups (clamped first), a
    validation pass one call of S groups."""
    calls = []

    class Counting(_TorchReplay):
        def sample_groups(self, generator, Q_shared, h_extra, num_reads):
            calls.append(tuple(h_extra.shape))
            return super().sample_groups(generator, Q_shared, h_extra, num_reads)

    sw = tsweep.SeedParallelDQBM(SEEDS, dim_input=D, n_hidden_nodes=H, sample_count=R,
                                 sampler=Counting(_variates(1 + H, len(SEEDS))), device="cpu")
    x, y, xv, yv = _data(False)
    sw.train(x, y, xv, yv, epochs=1, batch_size=B, verbose=False)
    assert calls == [(6, B, 1 + H)] * 2 + [(3, N_VAL, 1 + H)]


def test_flatlined_seeds_are_redrawn_with_the_shared_rule(monkeypatch):
    """Every N epochs the seeds that ``train.loop.flatlined`` finds are
    re-drawn at their next attempt; never after the last epoch."""
    import qbmx_torch.train.loop as loop

    asked = []
    monkeypatch.setattr(tsweep, "flatlined",
                        lambda accs, vy, w: asked.append(len(accs)) or len(asked) % 3 == 2)
    sw = tsweep.SeedParallelDQBM(SEEDS, dim_input=D, n_hidden_nodes=H, sample_count=4,
                                 anneal_steps=2, device="cpu")
    redrawn = []
    monkeypatch.setattr(sw, "reinit_seeds", lambda idx, attempt: redrawn.append((idx, attempt)))
    x, y, xv, yv = _data(False)
    sw.train(x, y, xv, yv, epochs=3, batch_size=B, verbose=False, reinit_on_collapse=1)
    assert asked == [1, 1, 1, 2, 2, 2]  # after epochs 1 and 2, not 3
    assert redrawn == [([1], 1), ([1], 2)]
    assert loop.flatlined([0.5, 0.5], [0, 1], 2) and not loop.flatlined([0.5, 0.6], [0, 1], 2)


@pytest.mark.parametrize("restricted", [False, True])
def test_best_model_pickles_cross_load(tmp_path, restricted):
    """The port's best-epoch pickles load into both packages' DiscQBM, and
    qbmx's sweep pickles into the port's."""
    kw = dict(dim_input=D, n_hidden_nodes=H, sample_count=4, anneal_steps=2,
              restricted=restricted)
    x, y, xv, yv = _data(False)
    ts = tsweep.SeedParallelDQBM(SEEDS, device="cpu", **kw)
    ts.train(x, y, xv, yv, epochs=2, batch_size=B, verbose=False)
    paths = ts.save_best_models(tmp_path / "torch")
    assert sorted(paths) == SEEDS
    for i, s in enumerate(SEEDS):
        want = td.params_to_numpy(ts.best_params_for_seed(i))
        assert Path(paths[s]).name == f"_se{s}_e{ts.best_epoch[i]}_best.pkl"
        for m in (td.DiscQBM(load_path=paths[s], device="cpu", **kw),
                  jd.DiscQBM(load_path=paths[s], **kw)):
            assert all(np.array_equal(np.asarray(getattr(m.params, k)), want[k]) for k in FIELDS)
    js = jsweep.SeedParallelDQBM(SEEDS, **kw)
    js.train(x, y, xv, yv, epochs=1, batch_size=B, verbose=False)
    for i, (s, path) in enumerate(js.save_best_models(tmp_path / "jax").items()):
        m = td.DiscQBM(load_path=path, device="cpu", **kw)
        want = js.best_params_for_seed(i)
        assert all(np.array_equal(td.params_to_numpy(m.params)[k], np.asarray(getattr(want, k)))
                   for k in FIELDS)


def test_committed_flagship_pickles_load_in_the_port():
    """``out/parity``'s breastmnist flagship weights (qbmx, h5, 20 epochs)."""
    paths = sorted(glob.glob(str(ROOT / "out/parity/_se*_h5_solSA_sc1000_*/e20.pkl")))
    assert len(paths) >= 10
    for path in paths:
        restricted = "_rTrue_" in path
        m = td.DiscQBM(dim_input=784, n_hidden_nodes=5, restricted=restricted, load_path=path,
                       device="cpu")
        want = pickle.load(open(path, "rb"))
        got = m.weight_objects()
        assert len(got) == len(want) == (5 if restricted else 6)
        assert all(np.array_equal(a, np.asarray(b, np.float32)) for a, b in zip(got, want))


def test_saving_before_validation_raises(tmp_path):
    sw = tsweep.SeedParallelDQBM(SEEDS, dim_input=D, n_hidden_nodes=H, device="cpu")
    with pytest.raises(RuntimeError, match="validation"):
        sw.save_best_models(tmp_path)
    with pytest.raises(RuntimeError, match="validation"):
        sw.best_params_for_seed(0)


SMALL = dict(data_set="synthetic", n_hidden_nodes=2, sample_count=4, anneal=2, batch_size=200,
             epochs=1)


@pytest.mark.parametrize("kw,match", [
    (dict(resume="state.npz"), "--resume/--checkpoint_every need"),
    (dict(checkpoint_every=1), "--resume/--checkpoint_every need"),
    (dict(load_path="w.pkl"), "--load_path needs"),
])
def test_seed_sweep_guards_raise_as_in_qbmx(kw, match):
    for main, extra in ((jmain.main, {}), (tmain.main, {"device": "cpu"})):
        with pytest.raises(ValueError, match=match):
            main(save="", seed_sweep=[1, 2], **SMALL, **kw, **extra)


def test_qbm_main_seed_sweep_writes_per_seed_results(tmp_path, capsys):
    """``qbm_main --seed_sweep`` on the CPU: one batched sweep, per-seed
    acc/auc pickles, one best-epoch pickle a seed that loads back."""
    accs, aucs = tmain.main(save=f"{tmp_path}/", name="sw", seed_sweep=[5, 6], device="cpu",
                            restricted=False, **SMALL)
    assert len(accs) == len(aucs) == 2 and all(0.0 <= a <= 1.0 for a in accs + aucs)
    out = capsys.readouterr().out
    assert "MEAN acc" in out and "seed 5: best acc" in out
    for s in (5, 6):
        assert len(pickle.load(open(tmp_path / f"swacc_per_epoch{s}.pkl", "rb"))) == 1
    pkls = sorted((tmp_path / "best_model").glob("sw_se*_e1_best.pkl"))
    assert len(pkls) == 2
    td.DiscQBM(dim_input=784, n_hidden_nodes=2, restricted=False, load_path=str(pkls[0]),
               device="cpu")
