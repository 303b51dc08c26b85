"""The exact-enumeration studies on the CPU, against ``qbmx``'s scripts:
``cli/exact_harness.py`` and ``cli/cdqbm_exact_study.py``,
``cli/cdqbm_breast_exact_study.py`` and ``cli/cdqbm_multikernel_study.py``
(``scripts/cdqbm_exact_study.py``, ``cdqbm_breast_exact_study.py``,
``cdqbm_multikernel_study.py``).

- ``make_bars`` is equal bit for bit, and each study's initial parameters
  (the models' own, on the numpy threefry) equal ``qbmx``'s for the
  same seed bit for bit.
- For CDQBM variants (argmin raw, absmax + signed, ``center_fmap``,
  probabilistic pooling with ``learn_penalty``, no pooling, two kernels,
  three kernels without a sequential layer, and the breast study's 28×28
  kernel 7) and the flat DQBM at h = 5 (36 and 784 inputs), on 16 images,
  from ``qbmx``'s parameters carried by ``params_from_numpy``: p(y=1|x)
  element-wise within 1e-5; the clipped NLL's gradient per leaf within
  1e-5 + 1e-4·|g| (float32 sums over up to 2¹³ states in another order);
  one Adam step on the same gradients within 1e-6 of optax's, and
  ``train_exact``'s first step that Adam step on the port's own gradient;
  after 20 steps p within 1e-4 and the accuracy equal.  Two cases are left
  out of the 20-step comparison, and a test shows why no tolerance holds
  there: the three-kernel model flips an absmax near-tie (|responses|
  within 1e-4) at step 2 with parameters still within 1e-5, and the
  784-input flat model saturates, so that ``qbmx`` against itself with the
  batch permuted already moves p past 1e-4.  (Adam's first step is
  lr·g/(|g| + 1e-8): a gradient entry near 1e-8 moves by up to lr on a
  float-order difference, which is why the packages' one-step results are
  compared on the same gradients.)
- ``pooled_bias_sensitivity`` within 1e-5 relative; the control, Bessel's
  std in place of numpy's population std, moves it by √(80/79) and fails
  that tolerance.
- On seeded MedMNIST files in a temporary working directory, ``load_breast``
  and ``load_medmnist`` give the same arrays in both packages, and each
  study's table, written under ``out/parity_torch/``, has the recorded
  tables' rows and QUBO-variable counts (those depend on the architecture
  alone).
"""

from __future__ import annotations

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from qbmx.models.cdqbm import CDQBM as JCDQBM
from qbmx.models.dqbm import DiscQBM as JDiscQBM
from qbmx.samplers.api import GibbsSampler as JGibbs
from qbmx_torch.cli import cdqbm_breast_exact_study as tb
from qbmx_torch.cli import cdqbm_exact_study as ts
from qbmx_torch.cli import cdqbm_multikernel_study as tk
from qbmx_torch.cli import exact_harness as xh
from qbmx_torch.models import cdqbm as tcdqbm
from qbmx_torch.models import dqbm as tdqbm
from qbmx_torch.models.base import tree_leaves, tree_map
from chip_smoke import MEDMNIST_SHAPES, write_medmnist
from scripts import cdqbm_breast_exact_study as jb
from scripts import cdqbm_exact_study as js
from scripts import cdqbm_multikernel_study as jk

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
P_ATOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
ADAM_ATOL = 1e-6
P20_ATOL = 1e-4
SENS_RTOL = 1e-5
LR = 0.05  # the studies' rate

DET = dict(kernel_size=3, pooling_size=2, pooling_type="deterministic",
           sequential_layer_sizes=[2], hidden_bias_type="shared")
PROB = dict(kernel_size=4, pooling_size=2, pooling_type="probabilistic",
            sequential_layer_sizes=[2], hidden_bias_type="shared")
# name: (image side, signed inputs, CDQBM keywords)
CDQBM_CASES = {
    "argmin raw": (6, False, DET),
    "absmax signed": (6, True, dict(DET, pool_select="absmax")),
    "center_fmap": (6, False, dict(DET, center_fmap=True)),
    "prob learn_penalty": (6, True, dict(PROB, prob_penalty=5.0, learn_penalty=True)),
    "no pooling": (6, False, dict(PROB, pooling_size=0, pooling_type="deterministic")),
    "n_kernels=2": (6, True, dict(DET, pool_select="absmax", n_kernels=2)),
    "seq[]": (6, True, dict(DET, pool_select="absmax", n_kernels=3, sequential_layer_sizes=[])),
    "28x28 k7s7": (28, True, dict(DET, kernel_size=7, stride=7, pool_select="absmax")),
}
FLAT = {"flat h=5": 36, "flat h=5, 784 inputs": 784}  # bars flattened; the breast study's width
CASES = list(CDQBM_CASES) + list(FLAT)
# Trajectories that float order alone separates (test_why_two_trajectories_part):
# a near-tie of absmax pooling flips at step 2, and a flat model whose
# 784-input fields saturate its marginals
UNSTABLE = ("seq[]", "flat h=5, 784 inputs")
STABLE = [c for c in CASES if c not in UNSTABLE]


def _images(side: int, n: int = 16, seed: int = 5):
    """Seeded inputs in [0, 1] and balanced-ish labels."""
    r = np.random.default_rng(seed)
    if side == 6:
        X, Y = js.make_bars(r, n_per_class=n // 2)
    else:
        X = r.integers(0, 256, (n, side, side)).astype(np.float32) / 255
        Y = (r.random(n) < 0.4).astype(np.float32)
    return X, Y


def _pair(case):
    """(qbmx p1 fn, qbmx params, port p1 fn, port params carried across,
    inputs, labels, the port model, the qbmx model)."""
    if case in FLAT:
        X, Y = _images(6 if FLAT[case] == 36 else 28)
        X = X.reshape(len(X), -1)
        jm = JDiscQBM(dim_input=FLAT[case], num_classes=2, n_hidden_nodes=5, seed=7,
                      beta_eff=1.0, sampler=JGibbs(num_warmup=2))
        tm = tdqbm.DiscQBM(dim_input=FLAT[case], num_classes=2, n_hidden_nodes=5, seed=7,
                           beta_eff=1.0, device="cpu")
        tp = tdqbm.params_from_numpy({k: np.asarray(getattr(jm.params, k)) for k in tdqbm.FIELDS})
        return jb.dqbm_p1, jm.params, xh.dqbm_p1, tp, X, Y, tm, jm
    side, signed, kw = CDQBM_CASES[case]
    X, Y = _images(side)
    if signed:
        X = X * 2.0 - 1.0
    jm = JCDQBM(image_shape=(side, side), num_label_nodes=1, seed=7, sample_count=8,
                sampler=JGibbs(num_warmup=2), **kw)
    tm = tcdqbm.CDQBM(image_shape=(side, side), num_label_nodes=1, seed=7, sample_count=8,
                      device="cpu", **kw)
    return (lambda p, x: jb.cdqbm_p1(jm, p, x), jm.params,
            lambda p, x: xh.cdqbm_p1(tm, p, x), tcdqbm.params_from_numpy(jm.params), X, Y,
            tm, jm)


def _jax_p1(p1_fn, params, X):
    return np.asarray(jax.jit(jax.vmap(lambda x: p1_fn(params, x)))(jnp.asarray(X)))


def _close(a, b, atol, rtol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=rtol, err_msg=what)


def test_make_bars_is_bit_for_bit():
    ra, rb = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(2):  # the train and then the test draw, as main() makes them
        (xa, ya), (xb, yb) = ts.make_bars(ra), js.make_bars(rb)
        assert xa.dtype == xb.dtype and ya.dtype == yb.dtype
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)


@pytest.mark.parametrize("case", CASES)
def test_qbmx_init_draws_qbmx_parameters(case):
    *_, tm, jm = _pair(case)
    ours, theirs = tree_leaves(tm.params), jax.tree.leaves(jm.params)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("case", CASES)
def test_p1_gradient_and_adam_step_match(case):
    jp1, jparams, tp1, tparams, X, Y, *_ = _pair(case)
    _close(tp1(tparams, torch.as_tensor(X)).detach(), _jax_p1(jp1, jparams, X), P_ATOL,
           what="p(y=1|x)")

    def jloss(p):  # the scripts' loss_fn
        p1 = jnp.clip(jax.vmap(lambda x: jp1(p, x))(jnp.asarray(X)), 1e-7, 1 - 1e-7)
        return -(Y * jnp.log(p1) + (1 - Y) * jnp.log(1 - p1)).mean()

    jg = [np.asarray(g) for g in jax.tree.leaves(jax.jit(jax.grad(jloss))(jparams))]
    leaves = [a.clone().requires_grad_(True) for a in tree_leaves(tparams)]
    it = iter(leaves)
    p = tree_map(lambda _: next(it), tparams)
    xh.clipped_nll(tp1(p, torch.as_tensor(X)), torch.as_tensor(Y)).backward()
    assert len(jg) == len(leaves)
    ours = [torch.zeros_like(a) if a.grad is None else a.grad for a in leaves]
    for i, (a, g) in enumerate(zip(ours, jg)):
        _close(a, g, GRAD_ATOL, GRAD_RTOL, what=f"gradient of leaf {i}")

    # one Adam step on the same gradients: optax's within ADAM_ATOL
    opt = optax.adam(LR)
    updates, _ = opt.update(jax.tree.unflatten(jax.tree.structure(jparams), jg),
                            opt.init(jparams), jparams)
    stepped = jax.tree.leaves(optax.apply_updates(jparams, updates))
    same = [a.detach().clone().requires_grad_(True) for a in tree_leaves(tparams)]
    for leaf, g in zip(same, jg):
        leaf.grad = torch.tensor(g)
    xh.adam(same, LR).step()
    for i, (a, b) in enumerate(zip(same, stepped)):
        _close(a.detach(), b, ADAM_ATOL, what=f"leaf {i} after one Adam step")

    # train_exact's first step is that Adam step on the port's own gradient,
    # and leaves the parameters it was given as they were
    own = [a.detach().clone().requires_grad_(True) for a in tree_leaves(tparams)]
    for leaf, g in zip(own, ours):
        leaf.grad = g.clone()
    xh.adam(own, LR).step()
    t1, _ = xh.train_exact(tp1, tparams, X, Y, steps=1, lr=LR)
    for a, b in zip(tree_leaves(t1), own):
        np.testing.assert_array_equal(a.numpy(), b.detach().numpy())
    for a, b in zip(tree_leaves(tparams), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("case", STABLE)
def test_twenty_adam_steps_match(case):
    jp1, jparams, tp1, tparams, X, Y, *_ = _pair(case)
    j20, jnll = jb.train_exact(jp1, jparams, X, Y, steps=20, lr=LR)
    t20, tnll = xh.train_exact(tp1, tparams, X, Y, steps=20, lr=LR)
    pj, pt = _jax_p1(jp1, j20, X), xh.predict_p1(tp1, t20, X)
    _close(pt, pj, P20_ATOL, what="p(y=1|x) after 20 steps")
    assert xh.accuracy(pt, Y) == float(((pj > 0.5).astype(np.float32) == Y).mean())
    assert tnll == pytest.approx(jnll, abs=P20_ATOL)


def test_why_two_trajectories_part():
    """The two cases left out of the 20-step comparison, and why no
    tolerance applies to them: (a) three kernels with absmax pooling on
    signed bars: after 2 steps the packages' parameters are within 1e-5,
    yet one window of one image picks another unit, whose |response| is
    within 1e-4 of the first (a near-tie flipped by float order; the
    gradient then flows through another unit); (b) the flat model at 784
    inputs of uniform noise: its fields saturate the marginals, and
    ``qbmx`` against itself, the batch merely permuted, moves p(y=1|x)
    after 20 steps by more than 1e-4."""
    jp1, jparams, tp1, tparams, X, Y, tm, jm = _pair("seq[]")
    j2, _ = jb.train_exact(jp1, jparams, X, Y, steps=2, lr=LR)
    t2, _ = xh.train_exact(tp1, tparams, X, Y, steps=2, lr=LR)
    for a, b in zip(tree_leaves(t2), jax.tree.leaves(j2)):
        _close(a, b, 1e-5)
    theirs = np.stack([np.asarray(jm._context(j2, jnp.asarray(x))[1]) for x in X])
    fmap, ours, _ = tm._context(t2, torch.as_tensor(X))
    flips = np.argwhere(ours.numpy() != theirs)
    assert len(flips) >= 1
    for b, w in flips:
        gap = abs(abs(float(fmap[b, ours[b, w]])) - abs(float(fmap[b, theirs[b, w]])))
        assert gap < 1e-4

    jp1, jparams, _, _, X, Y, *_ = _pair("flat h=5, 784 inputs")
    perm = np.random.default_rng(1).permutation(len(X))
    a, _ = jb.train_exact(jp1, jparams, X, Y, steps=20, lr=LR)
    b, _ = jb.train_exact(jp1, jparams, X[perm], Y[perm], steps=20, lr=LR)
    assert np.abs(_jax_p1(jp1, a, X) - _jax_p1(jp1, b, X)).max() > P20_ATOL


def _bars_models(case):
    _, _, kw = CDQBM_CASES[case]
    jm = JCDQBM(image_shape=(6, 6), num_label_nodes=1, seed=7, sample_count=8,
                sampler=JGibbs(num_warmup=2), **kw)
    tm = tcdqbm.CDQBM(image_shape=(6, 6), num_label_nodes=1, seed=7, sample_count=8,
                      device="cpu", **kw)
    return jm, tm


@pytest.mark.parametrize("case", [c for c in CDQBM_CASES if CDQBM_CASES[c][0] == 6])
def test_pooled_bias_sensitivity_matches(case):
    X, _ = ts.make_bars(np.random.default_rng(0))  # the study's 80 train images
    jm, tm = _bars_models(case)
    tp = tcdqbm.params_from_numpy(jm.params)
    theirs = js.pooled_bias_sensitivity(jm, jm.params, X)
    assert ts.pooled_bias_sensitivity(tm, tp, X) == pytest.approx(theirs, rel=SENS_RTOL)


def test_bessel_std_control_fails_the_sensitivity_tolerance():
    X, _ = ts.make_bars(np.random.default_rng(0))
    jm, tm = _bars_models("argmin raw")
    tp = tcdqbm.params_from_numpy(jm.params)
    theirs = js.pooled_bias_sensitivity(jm, jm.params, X)
    b = tm._conv_linear_terms(tp, tm._context(tp, torch.as_tensor(X)))
    bessel = float(b.std(dim=0, correction=1).mean())
    assert bessel == pytest.approx(theirs * np.sqrt(80 / 79), rel=SENS_RTOL)
    assert bessel != pytest.approx(theirs, rel=SENS_RTOL)


# -- the MedMNIST studies on seeded files --------------------------------------

@pytest.fixture(scope="module")
def medmnist_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("cwd")
    write_medmnist(root / "data")  # chip_smoke.py's seeded files of MedMNIST's shapes
    return root


@pytest.fixture
def in_medmnist_cwd(medmnist_dir, monkeypatch):
    """Both packages search ``./data``: ``qbmx`` fixes its roots at import,
    so the working directory, not ``$QBMX_DATA_DIR``, points both there."""
    monkeypatch.delenv("QBMX_DATA_DIR", raising=False)
    monkeypatch.chdir(medmnist_dir)
    return medmnist_dir


def test_load_breast_and_load_medmnist_match(in_medmnist_cwd):
    for ours, theirs in ((tb.load_breast(np.random.default_rng(0)),
                          jb.load_breast(np.random.default_rng(0))),
                         *((tk.load_medmnist(ds, np.random.default_rng(0)),
                            jk.load_medmnist(ds, np.random.default_rng(0)))
                           for ds in MEDMNIST_SHAPES)):
        assert len(ours[0]) == 160 and len(ours) == len(theirs) == 4
        for a, b in zip(ours, theirs):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def _recorded_vars(name: str) -> list[tuple[str, int]]:
    """(variant, QUBO vars) of each row of ``qbmx``'s recorded table."""
    rows = re.findall(r"^\| (.+?) \| (\d+) \|", (ROOT / "out/parity" / name).read_text(), re.M)
    return [(v, int(n)) for v, n in rows]


@pytest.mark.parametrize("study", ["breast", "multikernel"])
def test_study_tables_have_the_recorded_rows(in_medmnist_cwd, monkeypatch, study):
    """Each study's main at 2 Adam steps a row: the table it writes under
    ``out/parity_torch/`` has the recorded table's variants and QUBO-variable
    counts, and finite NLLs."""
    mod, name = {"breast": (tb, "cdqbm_breast_exact_study.md"),
                 "multikernel": (tk, "cdqbm_multikernel_study.md")}[study]
    short = lambda p1, params, X, Y, steps=2, lr=tb.LR: xh.train_exact(p1, params, X, Y, 2, lr)
    for m in (tb, mod):  # the multikernel study's flat rows are the breast study's
        monkeypatch.setattr(m, "train_exact", short)
    rows = mod.main(["--device", "cpu"])
    flat = rows if study == "breast" else [r for ds in tk.DATASETS for r in rows[ds]]
    assert all(np.isfinite(r["nll"]) for r in flat)
    written = (in_medmnist_cwd / "out/parity_torch" / name).read_text()
    ours = [(v, int(n)) for v, n in re.findall(r"^\| (.+?) \| (\d+) \|", written, re.M)]
    assert ours == _recorded_vars(name)
    assert not (in_medmnist_cwd / "out/parity").exists()
