"""qbmx_torch.models.dqbm / models.base against qbmx at small sizes.

QUBO constructors, moments and losses take the same numpy-made inputs in both
packages (rtol 1e-5, atol 1e-5: float32 products over up to O+D terms
summed in another order).  The slice as a whole: three ``DiscQBM`` steps and
one prediction in each package from the same converted parameters and
batches, each package's sampler replaying the same host variates -- qbmx's
through the TPU lane kernel in interpret mode, the port's through the plain
anneal.  Parameters, nll and err must agree within atol 1e-5.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qbmx.models.base as jbase
import qbmx.models.dqbm as jd
import qbmx_torch.models.base as tbase
from qbmx_torch.core import threefry
import qbmx_torch.models.dqbm as td
from qbmx.samplers.sa_lane import lane_sample_groups
from qbmx_torch.samplers import sa_torch

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
FIELDS = td.FIELDS


def _params(seed, D, H, O, restricted=False):
    rng = np.random.default_rng(seed)
    u = lambda *s: rng.uniform(-1, 1, s).astype(np.float32)
    return dict(w_vh=u(O + D, H), w_vo=u(D, O), w_oo=np.triu(u(O, O), 1), b_h=u(H),
                b_o=u(O), w_hh=np.zeros((H, H), np.float32) if restricted else np.triu(u(H, H), 1))


def _jparams(d):
    return jd.DQBMParams(**{k: jnp.asarray(v) for k, v in d.items()})


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **(tol or TOL))


def _close_tree(tp, jp, **tol):
    for k in FIELDS:
        _close(getattr(tp, k).cpu().numpy(), getattr(jp, k), **tol)


def _batch(seed, B, D, O, one_hot):
    rng = np.random.default_rng(seed)
    x = rng.random((B, D)).astype(np.float32)
    y = rng.integers(0, 2, B)
    y_vec = np.eye(2, dtype=np.float32)[y] if one_hot else y[:, None].astype(np.float32)
    return x, y, y_vec


def test_params_round_trip():
    d = _params(0, 7, 3, 1)
    p = td.params_from_numpy(d)
    assert all(getattr(p, k).dtype == torch.float32 for k in FIELDS)
    back = td.params_to_numpy(p)
    assert all(np.array_equal(back[k], d[k]) for k in FIELDS)
    j = _jparams(d)
    again = td.params_from_numpy({k: np.asarray(getattr(j, k)) for k in FIELDS})
    _close_tree(again, j, rtol=0, atol=0)


@pytest.mark.parametrize("restricted", [False, True])
def test_init_params_structure(restricted):
    p = td.init_params(threefry.key(0), 9, 4, 2, restricted)
    j = jd.init_params(jax.random.key(0), 9, 4, 2, restricted)
    for k in FIELDS:
        t = getattr(p, k)
        assert tuple(t.shape) == getattr(j, k).shape
        assert float(t.abs().max()) <= 1.0
        np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(j, k)))
    assert torch.equal(p.w_oo, torch.triu(p.w_oo, 1))
    assert torch.equal(p.w_hh, torch.triu(p.w_hh, 1))
    assert bool((p.w_hh == 0).all()) is restricted


@pytest.mark.parametrize("one_hot,restricted", [(False, False), (True, False), (False, True)])
def test_qubo_constructors_match(one_hot, restricted):
    D, H, B = 11, 4, 5
    O = 2 if one_hot else 1
    d = _params(1, D, H, O, restricted)
    x, _, y_vec = _batch(2, B, D, O, one_hot)
    tp, jp, beta = td.params_from_numpy(d), _jparams(d), 1.7
    tx, ty = torch.as_tensor(x), torch.as_tensor(y_vec)
    jx, jy = jnp.asarray(x), jnp.asarray(y_vec)
    Qc = td.clamped_qubo(tp, tx, ty, beta)
    Qu = td.unclamped_qubo(tp, tx, beta)
    _close(Qc, jd.clamped_qubo_batch(jp, jx, jy, beta))
    _close(Qu, jd.unclamped_qubo_batch(jp, jx, beta))
    _close(td.clamped_qubo_shared(tp, beta), jd.clamped_qubo_shared(jp, beta))
    _close(td.unclamped_qubo_shared(tp, beta), jd.unclamped_qubo_shared(jp, beta))
    _close(td.clamped_fields(tp, tx, ty, beta), jd.clamped_fields(jp, jx, jy, beta))
    _close(td.unclamped_fields(tp, tx, beta), jd.unclamped_fields(jp, jx, beta))
    # the structured form is exact: Q == Q_shared + diag(fields)
    _close(Qc, td.clamped_qubo_shared(tp, beta)
           + torch.diag_embed(td.clamped_fields(tp, tx, ty, beta)))
    _close(Qu, td.unclamped_qubo_shared(tp, beta)
           + torch.diag_embed(td.unclamped_fields(tp, tx, beta)))


@pytest.mark.parametrize("one_hot", [False, True])
def test_moments_and_mean_match(one_hot):
    D, H, B, R = 9, 3, 4, 6
    O = 2 if one_hot else 1
    rng = np.random.default_rng(3)
    x, _, y_vec = _batch(4, B, D, O, one_hot)
    s_h = (rng.random((B, R, H)) < 0.5).astype(np.float32)
    s = (rng.random((B, R, O + H)) < 0.5).astype(np.float32)
    mask = np.asarray([1, 1, 1, 0], np.float32)
    tc = td.clamped_moments(*map(torch.as_tensor, (s_h, x, y_vec)))
    jc = jd.clamped_moments(*map(jnp.asarray, (s_h, x, y_vec)))
    tu = td.unclamped_moments(torch.as_tensor(s), torch.as_tensor(x), O)
    ju = jd.unclamped_moments(jnp.asarray(s), jnp.asarray(x), O)
    _close_tree(tc, jc)
    _close_tree(tu, ju)
    _close_tree(td._masked_mean(tc, torch.as_tensor(mask)), jd._masked_mean(jc, jnp.asarray(mask)))
    _close_tree(td._masked_mean(tu, torch.zeros(B)), jd._masked_mean(ju, jnp.zeros(B)))


@pytest.mark.parametrize("one_hot", [False, True])
def test_probs_and_nll_match(one_hot):
    B, R, H = 5, 8, 2
    O = 2 if one_hot else 1
    rng = np.random.default_rng(5)
    s = (rng.random((B, R, O + H)) < 0.5).astype(np.float32)
    s[0, :, :O] = 0.0  # an example with no output fired: the 1/O and clip rules
    y = rng.integers(0, 2, B)
    mask = np.asarray([1, 1, 0, 1, 1], np.float32)
    tp = td.output_probs_from_samples(torch.as_tensor(s), O, one_hot)
    jp = jd.output_probs_from_samples(jnp.asarray(s), O, one_hot)
    _close(tp, jp)
    _close(td.nll_from_probs(tp, torch.as_tensor(y), torch.as_tensor(mask)),
           jd.nll_from_probs(jp, jnp.asarray(y), jnp.asarray(mask)))


def test_clip_and_pad_match():
    d = _params(6, 5, 3, 1)
    for max_norm in (0.5, 1e3):
        _close_tree(tbase.clip_by_global_norm(td.params_from_numpy(d), max_norm),
                    jbase.clip_by_global_norm(_jparams(d), max_norm))
    x = np.arange(6, dtype=np.float32).reshape(3, 2)
    _close(tbase.pad_rows(torch.as_tensor(x), 5), jbase.pad_rows(jnp.asarray(x), 5), rtol=0, atol=0)
    assert tbase.pad_rows(torch.as_tensor(x), 3).shape == (3, 2)


# -- the slice: matched-variate training steps in both packages --------------


class _JaxReplay:
    """qbmx sampler that hands the TPU lane kernel (interpret mode) the next
    set of host variates; host-bound, so qbmx builds its step eagerly."""

    jit_safe = False

    def __init__(self, variates, sweeps):
        self.variates, self.sweeps = list(variates), sweeps

    def sample_groups(self, key, Q_shared, h_extra, num_reads):
        init01, u = self.variates.pop(0)
        return lane_sample_groups(key, Q_shared, h_extra, num_reads, self.sweeps,
                                  rule="metropolis", interpret=True,
                                  debug_randoms=(jnp.asarray(init01), jnp.asarray(u)))


class _TorchReplay:
    """The port's counterpart: the plain anneal on the same variates."""

    def __init__(self, variates, sweeps):
        self.variates, self.sweeps = list(variates), sweeps

    def sample_groups(self, generator, Q_shared, h_extra, num_reads):
        init01, u = self.variates.pop(0)
        return sa_torch.sa_sample_groups_plain(
            Q_shared, h_extra, num_reads, self.sweeps,
            host_variates=(torch.as_tensor(init01), torch.as_tensor(u)))


@pytest.mark.parametrize("one_hot,restricted,shortcut,grad_clip", [
    (False, False, False, 0.0),
    (True, False, False, 0.5),
    (False, True, True, 0.0),    # linear shortcut: only the unclamped group is sampled
])
def test_three_steps_and_predict_match(one_hot, restricted, shortcut, grad_clip):
    D, H, B, R, S, N = 10, 3, 4, 8, 5, 6
    O = 2 if one_hot else 1
    n_u, G = O + H, 1 if shortcut else 2
    rng = np.random.default_rng(7)
    variates = [((rng.random((g, b, R, n_u)) < 0.5).astype(np.float32),
                 np.clip(rng.random((S, g, b, n_u, R)), 1e-6, 1 - 1e-6).astype(np.float32))
                for g, b in [(G, B)] * 3 + [(1, N)]]
    kw = dict(dim_input=D, n_hidden_nodes=H, sample_count=R, anneal_steps=S,
              restricted=restricted, use_one_hot_encoding=one_hot,
              use_linear_shortcut=shortcut, grad_clip=grad_clip)
    jm = jd.DiscQBM(sampler=_JaxReplay(variates, S), **kw)
    tm = td.DiscQBM(sampler=_TorchReplay(variates, S), device="cpu", **kw)
    d = _params(8, D, H, O, restricted)
    jm.params, tm.params = _jparams(d), td.params_from_numpy(d)
    for step in range(3):
        x, y, _ = _batch(10 + step, B, D, O, one_hot)
        mask = np.asarray([1, 1, 1, step != 2], np.float32)  # a padded tail on the last step
        jerr, jnll = jm.train_for_one_iteration(x, y, 0.3, mask=mask)
        terr, tnll = tm.train_for_one_iteration(x, y, 0.3, mask=mask)
        _close(float(tnll), float(jnll), rtol=0, atol=1e-5)
        _close(float(terr), float(jerr), rtol=0, atol=1e-5)
        _close_tree(tm.params, jm.params, rtol=0, atol=1e-5)
    X = np.random.default_rng(20).random((N, D)).astype(np.float32)
    (tpred, tprob), (jpred, jprob) = tm.predict_batch(X), jm.predict_batch(X)
    np.testing.assert_array_equal(tpred, jpred)
    _close(tprob, jprob, rtol=0, atol=1e-5)


# -- weight pickles across packages ---------------------------------------------


def _model(pkg, restricted, H=3, load_path=""):
    kw = dict(dim_input=6, n_hidden_nodes=H, restricted=restricted, load_path=load_path)
    return jd.DiscQBM(**kw) if pkg == "jax" else td.DiscQBM(device="cpu", **kw)


@pytest.mark.parametrize("src,dst", [("jax", "torch"), ("torch", "jax")])
@pytest.mark.parametrize("restricted", [False, True])
def test_weight_pickles_cross_load(tmp_path, src, dst, restricted):
    a = _model(src, restricted)
    a.save_weights("w", str(tmp_path))
    assert len(a.weight_objects()) == (5 if restricted else 6)
    b = _model(dst, restricted, load_path=str(tmp_path / "w.pkl"))
    for k in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(b.params, k)),
                                      np.asarray(getattr(a.params, k)))


@pytest.mark.parametrize("src,dst", [("jax", "torch"), ("torch", "jax")])
def test_weight_pickle_mismatch_raises(tmp_path, src, dst):
    _model(src, False).save_weights("w6", str(tmp_path))
    with pytest.raises(ValueError, match="visible->hidden"):
        _model(dst, False, H=4, load_path=str(tmp_path / "w6.pkl"))
    with pytest.raises(ValueError, match="6-tuple"):
        _model(dst, True, load_path=str(tmp_path / "w6.pkl"))
    with pytest.raises(FileNotFoundError):
        _model(dst, False, load_path=str(tmp_path / "missing.pkl"))


def test_reinit_is_a_function_of_seed_and_attempt():
    m = td.DiscQBM(dim_input=5, n_hidden_nodes=2, seed=3, device="cpu")
    first = td.params_to_numpy(m.params)
    m.reinit_params(attempt=1)
    second = td.params_to_numpy(m.params)
    m.reinit_params(attempt=0)
    assert all(np.array_equal(first[k], v) for k, v in td.params_to_numpy(m.params).items())
    assert not np.array_equal(first["w_vh"], second["w_vh"])
    assert m.get_num_params() == sum(v.size for v in first.values())


def test_sample_output_patterns_and_distribution():
    m = td.DiscQBM(dim_input=4, n_hidden_nodes=2, sample_count=8, anneal_steps=5, device="cpu")
    pats = m.sample_output_patterns(np.random.default_rng(0).random((3, 4)))
    assert pats.shape == (24, 1) and set(np.unique(pats)) <= {0.0, 1.0}
    dist = m.get_result_distribution(pats, ["0", "1"])
    assert abs(sum(dist) - 1.0) < 1e-9
    assert dataclasses.is_dataclass(m.params)


@pytest.mark.parametrize("seed", [0, 19, 3492574433])
@pytest.mark.parametrize("attempt", [0, 2])
@pytest.mark.parametrize("one_hot,restricted", [(False, False), (True, True)])
def test_a_model_starts_from_qbmx_parameters(seed, attempt, one_hot, restricted):
    """``DiscQBM(seed=s)`` and its ``reinit_params(attempt)`` draw ``qbmx``'s
    parameters for ``(s, attempt)`` bit for bit (a seed's runs in the two
    packages then differ only in the samplers' draws)."""
    kw = dict(dim_input=13, n_hidden_nodes=8, seed=seed, restricted=restricted,
              use_one_hot_encoding=one_hot)
    t, j = td.DiscQBM(device="cpu", **kw), jd.DiscQBM(**kw)
    if attempt:
        t.reinit_params(attempt)
        j.reinit_params(attempt)
    got = td.params_to_numpy(t.params)
    for k in FIELDS:
        np.testing.assert_array_equal(got[k], np.asarray(getattr(j.params, k)), err_msg=k)
