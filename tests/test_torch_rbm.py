"""qbmx_torch.models.rbm against qbmx.models.rbm at small sizes.

Both packages get the same numpy-made parameters and data.  Tolerances:

* ``class_logits`` / ``predict_proba`` / ``discriminative_nll``: 1e-6
  relative (float32 products summed in another order; torch's softplus
  goes linear past 20 where ``jax.nn.softplus`` is ``logaddexp(x, 0)``, at
  most 2e-9 apart);
* the autograd gradient against ``jax.grad``: 1e-5;
* ``cd_stats`` and one ``make_train_step`` a method, driven by ``qbmx``'s
  own variates drawn from its key splits (``jax.random.uniform`` for each
  Bernoulli, ``jax.random.gumbel`` for each categorical): 1e-5 in float32;
  in bfloat16 each intermediate (``ph0``, ``pv``, ``py``, ``phk``, the
  statistics) within 2 bf16 ulps (relative 2^-6): a value rounded to bf16
  from float32 results that differ in the last bits may land one ulp
  apart;
* ``train_rbm`` over 3 discriminative epochs without shuffling, from the
  same parameters: 1e-4, accuracy and AUC equal.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qbmx.models.rbm as jr
import qbmx_torch.models.rbm as tr
from qbmx_torch.core.rng import make_generator

torch.set_num_threads(1)
FIELDS = tr.FIELDS
BF16_RTOL = 2.0 ** -6  # 2 bf16 ulps


def _params(rng, V, H, C, scale=1.0):
    d = {"weights": scale * rng.normal(size=(V, H)), "visible_bias": rng.normal(size=V),
         "hidden_bias": rng.normal(size=H), "class_bias": rng.normal(size=C),
         "class_weights": scale * rng.normal(size=(C, H))}
    d = {k: np.asarray(v, np.float32) for k, v in d.items()}
    return jr.RBMParams(**{k: jnp.asarray(v) for k, v in d.items()}), tr.params_from_numpy(d)


def _np(p):
    """Fields of either package's params as numpy arrays."""
    if isinstance(p, tr.RBMParams):
        return tr.params_to_numpy(p)
    return {k: np.asarray(getattr(p, k), np.float32) for k in FIELDS}


def _close(a, b, rtol, atol=0.0):
    for k in FIELDS:
        np.testing.assert_allclose(_np(a)[k], _np(b)[k], rtol=rtol, atol=atol, err_msg=k)


def _data(rng, B, V, C, binary=True):
    x = rng.random((B, V)).astype(np.float32)
    if binary:
        x = (x > 0.5).astype(np.float32)
    return x, rng.integers(0, C, B).astype(np.int32)


def _f(t):
    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t, jnp.float32))


# -- exact discriminative path -------------------------------------------------


@pytest.mark.parametrize("C,binary", [(2, True), (3, False), (2, False)])
def test_logits_probs_and_nll_match(C, binary):
    rng = np.random.default_rng(C)
    jp, tp = _params(rng, 12, 5, C, scale=3.0)  # scale 3: some softplus inputs past 20
    x, y = _data(rng, 9, 12, C, binary)
    tx, ty = torch.as_tensor(x), torch.as_tensor(y)
    for fn in ("class_logits", "predict_proba"):
        np.testing.assert_allclose(_f(getattr(tr, fn)(tp, tx)),
                                   np.asarray(getattr(jr, fn)(jp, jnp.asarray(x))),
                                   rtol=1e-6, atol=1e-7, err_msg=fn)
    np.testing.assert_allclose(float(tr.discriminative_nll(tp, tx, ty)),
                               float(jr.discriminative_nll(jp, jnp.asarray(x), jnp.asarray(y))),
                               rtol=1e-6)


@pytest.mark.parametrize("C", [2, 4])
def test_autograd_gradient_matches_jax_grad(C):
    rng = np.random.default_rng(10 + C)
    jp, tp = _params(rng, 10, 4, C)
    x, y = _data(rng, 8, 10, C)
    nll, grad = tr.nll_and_grad(tp, torch.as_tensor(x), torch.as_tensor(y))
    jnll, jgrad = jax.value_and_grad(jr.discriminative_nll)(jp, jnp.asarray(x), jnp.asarray(y))
    assert float(nll) == pytest.approx(float(jnll), rel=1e-6)
    _close(grad, jgrad, rtol=1e-5, atol=1e-6)
    assert not grad.visible_bias.any()  # the visible bias does not enter p(y|x)


def test_predict_takes_the_first_of_tied_classes():
    """All-zero parameters: equal logits for every class; both packages
    predict class 0."""
    jrbm = jr.ClassificationRBM(num_visible=6, num_hidden=3, num_classes=3)
    trbm = tr.ClassificationRBM(num_visible=6, num_hidden=3, num_classes=3, device="cpu")
    zero = {k: np.zeros_like(v) for k, v in _np(trbm.params).items()}
    jrbm.params = jr.RBMParams(**{k: jnp.asarray(v) for k, v in zero.items()})
    trbm.params = tr.params_from_numpy(zero)
    x = np.random.default_rng(0).random((5, 6)).astype(np.float32)
    np.testing.assert_array_equal(trbm.predict(x), jrbm.predict(x))
    assert not trbm.predict(x).any()


# -- CD statistics under qbmx's own variates ------------------------------------


def _jax_variates(key, k, persistent, B, V, H, C):
    """The arrays qbmx's ``cd_stats`` draws from ``key``, in the order the
    chain uses them: per full Gibbs step the hidden and visible uniforms
    and the class Gumbel noise, then (mean-field CD) the final hidden
    uniforms."""
    def gibbs(ks):
        kh, kv, ky = jax.random.split(ks, 3)
        return [jax.random.uniform(kh, (B, H)), jax.random.uniform(kv, (B, V)),
                jax.random.gumbel(ky, (B, C))]

    out = []
    if persistent:
        for ks in jax.random.split(key, k):
            out += gibbs(ks)
        return [np.asarray(a) for a in out]
    if k > 1:
        keys = jax.random.split(key, k)
        for ks in keys[:-1]:
            out += gibbs(ks)
        key = keys[-1]
    out.append(jax.random.uniform(key, (B, H)))
    return [np.asarray(a) for a in out]


CD_CASES = [(1, False), (3, False), (2, True)]


def _cd_pair(k, persistent, dtype, seed=0, B=16, V=12, H=6, C=3, chain=False):
    rng = np.random.default_rng(seed)
    jp, tp = _params(rng, V, H, C)
    x, y = _data(rng, B, V, C)
    yo = np.eye(C, dtype=np.float32)[y]
    init = {}
    if chain:  # a persistent chain state different from the data
        vi, yi = _data(rng, B, V, C)
        init = dict(v_init=vi, y_init=np.eye(C, dtype=np.float32)[yi])
    key = jax.random.key(seed + 100)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jout = jr.cd_stats(jp, key, jnp.asarray(x), jnp.asarray(yo), k, compute_dtype=jdt,
                       persistent=persistent, **{n: jnp.asarray(a) for n, a in init.items()})
    draws = tr.Draws(variates=_jax_variates(key, k, persistent, B, V, H, C))
    tout = tr.cd_stats(tp, torch.as_tensor(x), torch.as_tensor(yo), k, compute_dtype=dtype,
                       persistent=persistent, draws=draws,
                       **{n: torch.as_tensor(a) for n, a in init.items()})
    return jp, tp, x, yo, jout, tout


@pytest.mark.parametrize("k,persistent", CD_CASES)
def test_cd_stats_f32_match_under_qbmx_variates(k, persistent):
    *_, (jpos, jneg, (jv, jy), jrec), (tpos, tneg, (tv, ty), trec) = _cd_pair(
        k, persistent, torch.float32, chain=persistent)
    _close(tpos, jpos, rtol=1e-5, atol=1e-6)
    _close(tneg, jneg, rtol=1e-5, atol=1e-6)
    for a, b in ((tv, jv), (ty, jy), (trec, jrec)):
        np.testing.assert_allclose(_f(a), _f(b), rtol=1e-5, atol=1e-6)
    if persistent:
        assert set(np.unique(_f(tv))) <= {0.0, 1.0} and set(np.unique(_f(ty))) <= {0.0, 1.0}


@pytest.mark.parametrize("k,persistent", CD_CASES)
def test_cd_stats_bf16_follow_jax_promotion(k, persistent):
    """bf16 mode, each intermediate: ph0 and phk (bf16 states times f32
    weights, promoted to f32, then rounded to bf16), the chain's pv / py,
    the reconstruction and the statistics (bf16 × bf16 products)."""
    jp, tp, x, yo, jout, tout = _cd_pair(k, persistent, torch.bfloat16, seed=3)
    (jpos, jneg, (jv, jy), jrec), (tpos, tneg, (tv, ty), trec) = jout, tout
    assert tv.dtype == torch.bfloat16 and trec.dtype == torch.bfloat16
    assert all(getattr(tneg, f).dtype == torch.float32 for f in FIELDS)
    bf = jnp.bfloat16
    ph0_j = jr._hidden_prob(jp, jnp.asarray(x, bf), jnp.asarray(yo, bf)).astype(bf)
    ph0_t = tr._hidden_prob(tp, torch.as_tensor(x, dtype=torch.bfloat16),
                            torch.as_tensor(yo, dtype=torch.bfloat16)).to(torch.bfloat16)
    assert ph0_t.dtype == torch.bfloat16
    np.testing.assert_allclose(_f(ph0_t), _f(ph0_j), rtol=BF16_RTOL, err_msg="ph0")
    # phk from the same (qbmx's) chain state
    phk_j = jr._hidden_prob(jp, jv, jy).astype(bf)
    phk_t = tr._hidden_prob(tp, torch.tensor(_f(jv)).to(torch.bfloat16),
                            torch.tensor(_f(jy)).to(torch.bfloat16)).to(torch.bfloat16)
    np.testing.assert_allclose(_f(phk_t), _f(phk_j), rtol=BF16_RTOL, err_msg="phk")
    for name, a, b in (("pv", tv, jv), ("py", ty, jy), ("recon", trec, jrec)):
        np.testing.assert_allclose(_f(a), _f(b), rtol=BF16_RTOL, atol=1e-6, err_msg=name)
    _close(tpos, jpos, rtol=BF16_RTOL, atol=1e-6)
    _close(tneg, jneg, rtol=BF16_RTOL, atol=1e-6)


# -- training steps -------------------------------------------------------------


STEP_CASES = [("discriminative", 0.0), ("generative", 0.0), ("hybrid", 0.005), ("pcd", 0.01),
              ("discriminative", 0.01), ("generative", 0.02)]


@pytest.mark.parametrize("method,sparse", STEP_CASES)
def test_one_train_step_matches(method, sparse):
    rng = np.random.default_rng(7)
    B, V, H, C = 10, 9, 4, 2
    jp, tp = _params(rng, V, H, C)
    x, y = _data(rng, B, V, C)
    kw = dict(method=method, cd_k=2 if method == "pcd" else 1, sparse_constant=sparse,
              generative_factor=0.3)
    jstep, tstep = jr.make_train_step(C, **kw), tr.make_train_step(C, **kw)
    key = jax.random.key(5)
    variates = _jax_variates(key, kw["cd_k"], method == "pcd", B, V, H, C)
    jargs, targs = (jp, key, jnp.asarray(x), jnp.asarray(y), 0.3), \
        (tp, torch.as_tensor(x), torch.as_tensor(y), 0.3)
    if method == "pcd":
        vi, yi = _data(rng, B, V, C)
        chain = (vi, np.eye(C, dtype=np.float32)[yi])
        jnew, jloss, jchain = jstep(*jargs, tuple(jnp.asarray(a) for a in chain))
        tnew, tloss, tchain = tstep(*targs, tuple(torch.as_tensor(a) for a in chain),
                                    variates=variates)
        for a, b in zip(tchain, jchain):
            np.testing.assert_array_equal(_f(a), _f(b))
    else:
        jnew, jloss = jstep(*jargs)
        tnew, tloss = tstep(*targs, variates=variates)
    _close(tnew, jnew, rtol=1e-5, atol=1e-6)
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-5, abs=1e-7)


def test_unknown_method_raises():
    """A mistyped method would silently train nothing."""
    with pytest.raises(ValueError, match="unknown method"):
        tr.make_train_step(num_classes=2, method="Discriminative")
    with pytest.raises(ValueError, match="unknown method"):
        tr.ClassificationRBM(num_visible=4, num_hidden=2, method="cd", device="cpu")


# -- the stateful model -------------------------------------------------------------


def _models(V, H, seed=0, **kw):
    """A qbmx and a port ClassificationRBM, the port's carrying qbmx's
    initial parameters."""
    jrbm = jr.ClassificationRBM(num_visible=V, num_hidden=H, seed=seed, **kw)
    trbm = tr.ClassificationRBM(num_visible=V, num_hidden=H, seed=seed, device="cpu", **kw)
    trbm.params = tr.params_from_numpy(_np(jrbm.params))
    return jrbm, trbm


@pytest.mark.parametrize("n,batch", [(47, 10), (40, 10), (12, 64)],
                         ids=["remainder batch", "whole batches", "oversized batch"])
def test_train_rbm_trajectory_matches(n, batch):
    """3 discriminative epochs without shuffling: the remainder batch is
    trained, and a batch larger than the set trains the set as one."""
    rng = np.random.default_rng(n)
    x, y = _data(rng, n, 10, 2)
    tx, ty = _data(rng, 30, 10, 2)
    jrbm, trbm = _models(10, 5, learning_rate=0.2, sparse_constant=0.001)
    jloss, _, jnll = jrbm.train_rbm(x, y, epochs=3, batch_size=batch, test_x=tx, test_y=ty,
                                    shuffle=False)
    tloss, _, tnll = trbm.train_rbm(x, y, epochs=3, batch_size=batch, test_x=tx, test_y=ty,
                                    shuffle=False)
    _close(trbm.params, jrbm.params, rtol=0, atol=1e-4)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-4)
    assert tnll == tloss and trbm.nll_per_epoch_list == tloss
    assert trbm.acc_per_epoch_list == jrbm.acc_per_epoch_list
    np.testing.assert_allclose(trbm.auc_per_epoch_list, jrbm.auc_per_epoch_list, atol=1e-12)
    assert trbm.run_test_set(tx, ty) == pytest.approx(jrbm.run_test_set(tx, ty), abs=1e-12)
    assert trbm.get_num_params() == jrbm.get_num_params()


def test_image_shaped_inputs_and_shuffle():
    rng = np.random.default_rng(1)
    x = (rng.uniform(0, 1, (10, 4, 4)) > 0.5).astype("float32")
    y = rng.integers(0, 2, 10).astype("float32")
    rbm = tr.ClassificationRBM(num_visible=16, num_hidden=4, learning_rate=0.1, seed=0,
                               device="cpu")
    loss, _, _ = rbm.train_rbm(x, y, epochs=2, batch_size=3, test_x=x, test_y=y)
    assert len(loss) == 2 and np.isfinite(loss).all()
    assert rbm.predict(x).shape == (10,)


def test_initial_params_come_from_the_seed():
    a = tr.ClassificationRBM(num_visible=7, num_hidden=3, seed=4, device="cpu")
    b = tr.ClassificationRBM(num_visible=7, num_hidden=3, seed=4, device="cpu")
    want = tr.init_params(make_generator(4, 0), 7, 3, 2)
    for p in (a.params, b.params):
        _close(p, want, rtol=0)
    assert float(a.params.visible_bias[0]) == 0.5 and not a.params.class_weights.any()
    assert abs(float(a.params.weights.std()) - 0.1) < 0.05


def test_pcd_refusals():
    rng = np.random.default_rng(2)
    x, y = _data(rng, 6, 8, 2)
    rbm = tr.ClassificationRBM(num_visible=8, num_hidden=3, seed=0, method="pcd", device="cpu")
    with pytest.raises(ValueError, match="batch_size"):
        rbm.train_rbm(x, y, epochs=1, batch_size=64)
    with pytest.raises(ValueError, match="checkpoint_every"):
        rbm.train_rbm(x, y, epochs=1, batch_size=2, checkpoint_every=1, checkpoint_path="x")


def test_pcd_keeps_a_binary_chain_and_learns():
    modes = np.asarray([[1, 1, 1, 1, 0, 0, 0, 0], [0, 0, 0, 0, 1, 1, 1, 1]], dtype="float32")
    idx = np.random.default_rng(3).integers(0, 2, 120)
    rbm = tr.ClassificationRBM(num_visible=8, num_hidden=6, learning_rate=0.1, seed=0,
                               method="pcd", device="cpu")
    loss, _, _ = rbm.train_rbm(modes[idx], idx, epochs=6, batch_size=24)
    v, y = rbm._chain
    assert set(np.unique(v.numpy())) <= {0.0, 1.0} and set(np.unique(y.numpy())) <= {0.0, 1.0}
    assert loss[-1] < loss[0]


def test_flatlined_model_is_redrawn_deterministically():
    """lr 0 and one class: only the re-draw (``train.loop.flatlined``) can
    move the weights, to ``init_params(make_generator(seed, 1))``."""
    rng = np.random.default_rng(4)
    x = (rng.uniform(0, 1, (12, 10)) > 0.5).astype("float32")
    y = np.zeros(12, dtype="float32")  # majority fraction 1.0
    runs = []
    for _ in range(2):
        rbm = tr.ClassificationRBM(num_visible=10, num_hidden=4, seed=0, learning_rate=0.0,
                                   device="cpu")
        before = rbm.params.weights.clone()
        rbm.train_rbm(x, y, epochs=2, batch_size=6, test_x=x, test_y=y, reinit_on_collapse=1)
        assert not torch.equal(before, rbm.params.weights) and rbm._reinit_attempt == 1
        runs.append(rbm.params)
    _close(runs[0], runs[1], rtol=0)
    _close(runs[0], tr.init_params(make_generator(0, 1), 10, 4, 2), rtol=0)


def test_bf16_cd1_learns_like_f32():
    """The throughput mode trains to comparable accuracy, parameters f32
    (qbmx's ``TestBf16ComputeMode``)."""
    rng = np.random.default_rng(0)
    base = rng.uniform(0, 1, (2, 16))
    y = rng.integers(0, 2, 256)
    x = ((0.7 * base[y] + 0.3 * rng.uniform(0, 1, (256, 16))) > 0.5).astype("float32")
    accs = {}
    for dt in (torch.float32, torch.bfloat16):
        epoch = tr.make_epoch_scan(tr.make_train_step(2, method="generative", compute_dtype=dt))
        params = tr.init_params(torch.Generator().manual_seed(0), 16, 8, 2)
        gen = torch.Generator().manual_seed(1)
        xb = torch.as_tensor(x.reshape(8, 32, 16)).to(dt)
        yb = torch.as_tensor(y.reshape(8, 32))
        for _ in range(30):
            params, loss = epoch(params, gen, xb, yb, 0.1)
        assert params.weights.dtype == torch.float32 and torch.isfinite(loss)
        preds = tr.predict_proba(params, torch.as_tensor(x)).argmax(-1).numpy()
        accs[dt] = (preds == y).mean()
    assert accs[torch.bfloat16] >= accs[torch.float32] - 0.05
    assert accs[torch.float32] > 0.9


def test_weight_pickles_load_both_ways(tmp_path):
    jrbm, trbm = _models(6, 3, seed=2)
    trbm.params = tr.params_from_numpy({k: v + 1.0 for k, v in _np(trbm.params).items()})
    trbm.save_weights("port", str(tmp_path))
    jrbm.save_weights("jax", str(tmp_path))
    j2 = jr.ClassificationRBM(num_visible=6, num_hidden=3)
    j2.load_params(tmp_path / "port.pkl")
    _close(j2.params, trbm.params, rtol=0)
    t2 = tr.ClassificationRBM(num_visible=6, num_hidden=3, device="cpu")
    t2.load_params(tmp_path / "jax.pkl")
    _close(t2.params, jrbm.params, rtol=0)
    with pytest.raises(FileNotFoundError):
        t2.load_params(tmp_path / "absent.pkl")


def test_cuda_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tr.ClassificationRBM(num_visible=4, num_hidden=2)
