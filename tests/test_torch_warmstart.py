"""qbmx_torch.models.warmstart against qbmx.models.warmstart.

``rbm_to_dqbm_params`` maps the same RBM parameters to the same DQBM
parameters exactly (sign flips, one subtraction and one addition, all
exact in float32), for one-hot labels and the single binary node.  The
warm-started ``DiscQBM`` keeps the RBM's decision function: its exact
unclamped p(y=1|x) equals the RBM's within 1e-5, and sampled with the
exact sampler (4096 reads) within ``qbmx``'s 0.06
(``tests/test_rbm.py::TestWarmStart``).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qbmx.models.rbm as jr
import qbmx.models.warmstart as jw
import qbmx_torch.models.dqbm as td
import qbmx_torch.models.rbm as tr
import qbmx_torch.models.warmstart as tw
from qbmx_torch.samplers.api import get_sampler
from qbmx_torch.samplers.exact import exact_boltzmann

torch.set_num_threads(1)


def toy_data(rng, n=60, D=6):
    x = (rng.uniform(0, 1, (n, D)) > 0.5).astype("float32")
    w = rng.normal(size=D)
    y = (x @ w > np.median(x @ w)).astype("int32")
    return x, y


@pytest.mark.parametrize("C,one_hot", [(3, True), (2, True), (2, False)])
def test_rbm_to_dqbm_params_equals_qbmx(C, one_hot):
    rng = np.random.default_rng(C + one_hot)
    d = {k: rng.normal(size=s).astype(np.float32) for k, s in
         zip(tr.FIELDS, ((7, 4), (7,), (4,), (C,), (C, 4)))}
    want = jw.rbm_to_dqbm_params(jr.RBMParams(**{k: jnp.asarray(v) for k, v in d.items()}),
                                 one_hot)
    got = td.params_to_numpy(tw.rbm_to_dqbm_params(tr.params_from_numpy(d), one_hot))
    for k in td.FIELDS:
        w = np.asarray(getattr(want, k))
        assert got[k].shape == w.shape and got[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_binary_node_needs_two_classes():
    p = tr.init_params(torch.Generator().manual_seed(0), 5, 3, 3)
    with pytest.raises(ValueError, match="2-class"):
        tw.rbm_to_dqbm_params(p, use_one_hot=False)


def _trained_rbm(rng, epochs=5):
    x, y = toy_data(rng)
    rbm = tr.ClassificationRBM(num_visible=6, num_hidden=3, num_classes=2, learning_rate=0.3,
                               seed=1, device="cpu")
    rbm.train_rbm(x, y, epochs=epochs, batch_size=12)
    return rbm, x, y


def test_warm_start_preserves_decision_function(rng):
    """The mapped DQBM's p(y=1|x): exact from its unclamped QUBO within
    1e-5, and sampled by the exact sampler within 0.06, of the RBM's."""
    rbm, x, _ = _trained_rbm(rng)
    rbm_probs = tr.predict_proba(rbm.params, torch.as_tensor(x[:10])).numpy()
    model = tw.warm_start_dqbm(rbm, seed=0, sample_count=4096, sampler=get_sampler("EXACT"))
    assert model.device == rbm.device and not model.use_one_hot_encoding
    Qu = td.unclamped_qubo(model.params, torch.as_tensor(x[:10]), model.beta_eff)
    exact = np.asarray([float(exact_boltzmann(q)[2][0]) for q in Qu])
    np.testing.assert_allclose(exact, rbm_probs[:, 1], atol=1e-5)
    _, qbm_probs = model.predict_batch(x[:10])
    np.testing.assert_allclose(qbm_probs[:, 1], rbm_probs[:, 1], atol=0.06)


def test_one_hot_warm_start_matches_qbmx_dqbm():
    """A 3-class RBM warm-starts a one-hot DQBM whose parameters equal the
    ones ``qbmx``'s warm start gives the same RBM."""
    rng = np.random.default_rng(5)
    trbm = tr.ClassificationRBM(num_visible=5, num_hidden=2, num_classes=3, device="cpu")
    jrbm = jr.ClassificationRBM(num_visible=5, num_hidden=2, num_classes=3)
    d = {k: rng.normal(size=v.shape).astype(np.float32)
         for k, v in tr.params_to_numpy(trbm.params).items()}
    trbm.params = tr.params_from_numpy(d)
    jrbm.params = jr.RBMParams(**{k: jnp.asarray(v) for k, v in d.items()})
    tm = tw.warm_start_dqbm(trbm, seed=0, sampler=get_sampler("EXACT"))
    jm = jw.warm_start_dqbm(jrbm, seed=0)
    assert tm.use_one_hot_encoding and tm.n_output_nodes == 3
    got = td.params_to_numpy(tm.params)
    for k in td.FIELDS:
        np.testing.assert_array_equal(got[k], np.asarray(getattr(jm.params, k)), err_msg=k)


def test_warm_start_then_sampled_training_improves(rng):
    """No catastrophic forgetting over 10 sampled steps (``qbmx``'s test)."""
    rbm, x, y = _trained_rbm(rng, epochs=2)
    model = tw.warm_start_dqbm(rbm, seed=0, sample_count=128,
                               sampler=get_sampler("BMS", num_sweeps=16))
    preds0, _ = model.predict_batch(x)
    acc0 = (preds0 == y).mean()
    for _ in range(10):
        model.train_for_one_iteration(x, y.astype("float32"), 0.3)
    preds1, _ = model.predict_batch(x)
    assert (preds1 == y).mean() >= acc0 - 0.05
