"""qbmx_torch's CDQBM slice (models/geometry, models/cdqbm, data/coreset,
cli/cdqbm_main) against qbmx at small sizes: 8×8 images, k=3, pool 2,
``seq_sizes (3,)`` -- 49 variables with probabilistic pooling, 13 with
deterministic.

Inputs are made with numpy from a seed and fed to both packages; the port
works on batches where qbmx vmaps a per-image function.  Tolerances:
geometry and penalty tables exactly; QUBO builders element-wise within
atol 1e-6 (float32 sums of at most 9 terms, taken in another order by the
two einsums); moments within rtol 1e-5 and atol 1e-5 (float32 sums over up
to 72 conv units and R reads in another order).  Three matched training
steps and a prediction: each package's sampler replays the same host
variates, qbmx's through the TPU lane kernel in interpret mode, the
port's through the plain anneal; parameters, nll and err within atol 1e-5.
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
import qbmx.models.geometry as jgeo
import qbmx_torch.models.cdqbm as tc
import qbmx_torch.models.geometry as tgeo
from qbmx.cli import cdqbm_main as jmain
from qbmx.data import coreset as jcore
from qbmx.samplers.sa_lane import lane_sample_groups
from qbmx_torch.cli import cdqbm_main as tmain
from qbmx_torch.data import coreset as tcore
from qbmx_torch.samplers import sa_torch

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
BASE = dict(image_shape=(8, 8), kernel_size=3, pooling_size=2, sequential_layer_sizes=[3])


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **(tol or TOL))


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


def _close_tree(tp, jp, **tol):
    t, j = _leaves(tp), _leaves(jp)
    assert t.keys() == j.keys()
    for k in t:
        np.testing.assert_allclose(t[k], j[k], err_msg=k, **(tol or TOL))


def _models(seed=0, **kw):
    """(qbmx model, port model) of one configuration, the port's params set
    to qbmx's."""
    jm = jc.CDQBM(seed=seed, **{**BASE, **kw})
    tm = tc.CDQBM(seed=seed, device="cpu", **{**BASE, **kw})
    tm.params = tc.params_from_numpy(jm.params)
    return jm, tm


def _images(seed, B, shape=(8, 8)):
    return np.random.default_rng(seed).random((B,) + shape).astype(np.float32)


# -- geometry -------------------------------------------------------------------


GEOMETRIES = [
    dict(pooling_type=pt, n_kernels=nk, pooling_size=ps, seq_sizes=seq, n_out=no)
    for pt in ("deterministic", "probabilistic") for nk in (1, 2)
    for ps, seq, no in ((2, (3,), 1), (4, (4, 2), 2), (0, (), 1))
]
PROPERTIES = ("conv_dim", "num_conv_units", "conv_units_total", "n_windows", "has_pooling",
              "conv_active", "n_pooled", "n_pool_vars", "n_hidden", "n_total", "conv_slice",
              "pool_slice", "seq_slices", "out_slice", "last_hidden_slice",
              "last_hidden_size", "stats_drop", "sizes_active", "stats_starts",
              "n_stats_hidden")


@pytest.mark.parametrize("cfg", GEOMETRIES)
def test_geometry_matches(cfg):
    kw = dict(image_shape=(10, 9), kernel_size=3, stride=1, **cfg)
    t, j = tgeo.StackGeometry(**kw), jgeo.StackGeometry(**kw)
    for name in PROPERTIES:
        assert getattr(t, name) == getattr(j, name), name
    np.testing.assert_array_equal(t.pool_windows, j.pool_windows)
    np.testing.assert_array_equal(tgeo.patch_index_grid((10, 9), 3, 2),
                                  jgeo.patch_index_grid((10, 9), 3, 2))


def test_geometry_of_the_cli_shapes():
    """The CLI's probabilistic shape is the 717-variable QUBO, its defaults 41."""
    geo = lambda pt: tgeo.StackGeometry((28, 28), 3, 1, 4, pt, (4,), 1)
    assert (geo("probabilistic").n_hidden, geo("probabilistic").n_total) == (716, 717)
    assert geo("deterministic").n_total == 41


@pytest.mark.parametrize("n_kernels", [1, 2])
def test_penalty_tables_match(n_kernels):
    geo = tgeo.StackGeometry((8, 8), 3, 1, 2, "probabilistic", (3,), 1, n_kernels)
    jg = jgeo.StackGeometry((8, 8), 3, 1, 2, "probabilistic", (3,), 1, n_kernels)
    np.testing.assert_array_equal(tc.build_penalty_basis(geo), jc.build_penalty_basis(jg))
    np.testing.assert_array_equal(tc.build_penalty_matrix(geo, 1.3),
                                  jc.build_penalty_matrix(jg, 1.3))
    assert tc.PROB_POOL_PENALTY == jc.PROB_POOL_PENALTY


# -- QUBO builders and moments ------------------------------------------------------

BUILDER_CASES = [
    dict(pooling_type=pt, hidden_bias_type=hb)
    for pt in ("deterministic", "probabilistic") for hb in ("shared", "none", "per-unit")
] + [
    dict(pooling_type="probabilistic", learn_penalty=True, hidden_bias_type="per-unit"),
    dict(pooling_type="deterministic", num_label_nodes=2, n_kernels=2, is_restricted=True),
    dict(pooling_type="deterministic", pool_select="absmax", center_fmap=True),
    dict(pooling_type="deterministic", pool_select="max", pooling_size=0),
]


def _label_vecs(seed, B, n_out):
    y = np.random.default_rng(seed).integers(0, 2, B)
    return np.eye(2, dtype=np.float32)[y] if n_out == 2 else y[:, None].astype(np.float32)


@pytest.mark.parametrize("cfg", BUILDER_CASES)
def test_qubo_builders_match(cfg):
    jm, tm = _models(seed=1, beta_eff=1.7, **cfg)
    if cfg.get("learn_penalty"):  # distinct learned strengths per window
        pen = np.random.default_rng(9).uniform(0.5, 1.5, tm.geo.n_windows).astype(np.float32)
        jm.params = dataclasses.replace(jm.params, pen=jnp.asarray(pen))
        tm.params.pen = torch.as_tensor(pen)
    B = 4
    x = _images(2, B)
    yv = _label_vecs(3, B, tm.geo.n_out)
    tp, jp = tm.params, jm.params
    tx, ty, jx, jy = torch.as_tensor(x), torch.as_tensor(yv), jnp.asarray(x), jnp.asarray(yv)
    atol = dict(rtol=0, atol=1e-6)
    Qc = tm.clamped_qubo(tp, tx, ty)
    Qu = tm.unclamped_qubo(tp, tx)
    _close(Qc, jax.vmap(lambda a, b: jm.clamped_qubo(jp, a, b))(jx, jy), **atol)
    _close(Qu, jax.vmap(lambda a: jm.unclamped_qubo(jp, a))(jx), **atol)
    _close(tm.clamped_qubo_shared(tp), jm.clamped_qubo_shared(jp), **atol)
    _close(tm.unclamped_qubo_shared(tp), jm.unclamped_qubo_shared(jp), **atol)
    _close(tm.clamped_fields(tp, tx, ty),
           jax.vmap(lambda a, b: jm.clamped_fields(jp, a, b))(jx, jy), **atol)
    _close(tm.unclamped_fields(tp, tx), jax.vmap(lambda a: jm.unclamped_fields(jp, a))(jx), **atol)
    # the structured pair is the dense QUBO: shared + diag(fields)
    _close(Qc, tm.clamped_qubo_shared(tp) + torch.diag_embed(tm.clamped_fields(tp, tx, ty)), **atol)
    _close(Qu, tm.unclamped_qubo_shared(tp) + torch.diag_embed(tm.unclamped_fields(tp, tx)), **atol)
    # the context: feature map and the pooled units
    fmap, pooled, patches = tm._context(tp, tx)
    jfmap, jpooled, jpatches = jax.vmap(lambda a: jm._context(jp, a))(jx)
    _close(fmap, jfmap, **atol)
    np.testing.assert_array_equal(pooled.numpy(), np.asarray(jpooled))
    np.testing.assert_array_equal(patches.numpy(), np.asarray(jpatches))


@pytest.mark.parametrize("cfg", BUILDER_CASES)
def test_moments_match(cfg):
    jm, tm = _models(seed=4, **cfg)
    B, R = 3, 6
    x = _images(5, B)
    yv = _label_vecs(6, B, tm.geo.n_out)
    rng = np.random.default_rng(7)
    s_c = (rng.random((B, R, tm.geo.n_hidden)) < 0.5).astype(np.float32)
    s_u = (rng.random((B, R, tm.geo.n_total)) < 0.5).astype(np.float32)
    tx, jx = torch.as_tensor(x), jnp.asarray(x)
    ctx = tm._context(tm.params, tx)
    jp = jm.params
    _close_tree(tm._moments(tm.params, torch.as_tensor(s_c), ctx, torch.as_tensor(yv)),
                jax.vmap(lambda s, a, b: jm._moments(jp, s, a, b))(
                    jnp.asarray(s_c), jx, jnp.asarray(yv)))
    _close_tree(tm._moments(tm.params, torch.as_tensor(s_u), ctx),
                jax.vmap(lambda s, a: jm._moments(jp, s, a))(jnp.asarray(s_u), jx))


def test_params_round_trip_and_init_structure():
    jm, tm = _models(seed=2, pooling_type="probabilistic", learn_penalty=True)
    back = tc.params_to_numpy(tm.params)
    assert isinstance(back["w_seq"], tuple) and back["pen"].shape == (tm.geo.n_windows,)
    _close_tree(tc.params_from_numpy(back), jm.params, rtol=0, atol=0)
    fresh = tc.CDQBM(seed=2, device="cpu", pooling_type="probabilistic", learn_penalty=True,
                     **BASE).params
    shapes = lambda p: {k: v.shape for k, v in _leaves(p).items()}
    assert shapes(fresh) == shapes(jm.params)
    assert all(float(np.abs(v).max()) <= 1.0 for k, v in _leaves(fresh).items() if k != "pen")
    assert torch.all(fresh.pen == tc.PROB_POOL_PENALTY)
    with pytest.raises(ValueError, match="learn_penalty"):
        tc.CDQBM(device="cpu", learn_penalty=True, **BASE)


# -- the slice: matched-variate training steps in both packages ------------------


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


STEP_CASES = [
    dict(pooling_type="deterministic"),
    dict(pooling_type="probabilistic", grad_clip=0.5),
    dict(pooling_type="probabilistic", learn_penalty=True, hidden_bias_type="per-unit"),
    dict(pooling_type="deterministic", num_label_nodes=2, is_restricted=True),
    dict(pooling_type="deterministic", n_kernels=2, hidden_bias_type="none"),
]


@pytest.mark.parametrize("cfg", STEP_CASES)
def test_three_steps_and_predict_match(cfg):
    B, R, S, N, chunk = 4, 8, 5, 6, 32
    geo = tgeo.StackGeometry((8, 8), 3, 1, 2, cfg["pooling_type"], (3,),
                             cfg.get("num_label_nodes", 1), cfg.get("n_kernels", 1))
    n = geo.n_total
    rng = np.random.default_rng(11)
    variates = [((rng.random((g, b, R, n)) < 0.5).astype(np.float32),
                 np.clip(rng.random((S, g, b, n, R)), 1e-6, 1 - 1e-6).astype(np.float32))
                for g, b in [(2, B)] * 3 + [(1, chunk)]]
    kw = dict(sample_count=R, beta_eff=2.0, hidden_bias_type="shared", **BASE)
    kw.update(cfg)
    jm = jc.CDQBM(seed=3, sampler=_JaxReplay(variates, S), **kw)
    tm = tc.CDQBM(seed=3, sampler=_TorchReplay(variates, S), device="cpu", **kw)
    tm.params = tc.params_from_numpy(jm.params)
    for step in range(3):
        x = _images(20 + step, B)
        y = np.random.default_rng(30 + step).integers(0, 2, B)
        mask = np.asarray([1, 1, 1, step != 2], np.float32)  # a padded tail on the last step
        xs = x.reshape(B, -1) if step == 1 else x  # flat rows are reshaped to images
        jerr, jnll = jm.train_for_one_iteration(xs, y, 0.3, mask=mask)
        terr, tnll = tm.train_for_one_iteration(xs, y, 0.3, mask=mask)
        _close(float(tnll), float(jnll), rtol=0, atol=1e-5)
        _close(float(terr), float(jerr), rtol=0, atol=1e-5)
        _close_tree(tm.params, jm.params, rtol=0, atol=1e-5)
    X = _images(40, N).reshape(N, -1)
    (tpred, tprob), (jpred, jprob) = tm.predict_batch(X), jm.predict_batch(X)
    np.testing.assert_array_equal(tpred, jpred)
    _close(tprob, jprob, rtol=0, atol=1e-5)


def test_train_epoch_runs_images_and_counts_steps():
    """``train_model``'s whole-epoch path hands the CDQBM flat rows or
    images; both give the same steps from one generator state."""
    from qbmx_torch.train.loop import train_model

    kw = dict(seed=5, sample_count=4, anneal=3, device="cpu", pooling_type="probabilistic",
              **BASE)
    x = _images(50, 10)
    y = np.arange(10) % 2
    a, b = tc.CDQBM(**kw), tc.CDQBM(**kw)
    ha = train_model(a, x, y, batch_size=4, epochs=1, verbose=False)
    hb = train_model(b, x.reshape(10, -1), y, batch_size=4, epochs=1, verbose=False)
    assert len(ha.nll_per_batch) == 3 and ha.nll_per_batch == hb.nll_per_batch
    _close_tree(a.params, b.params, rtol=0, atol=0)


def test_pipeline_runs_and_embedding():
    tm = tc.CDQBM(seed=1, sample_count=6, anneal=4, device="cpu",
                  pooling_type="probabilistic", **BASE)
    x = _images(60, 1)[0]
    s, probs = tm.run_unclamped(x)
    assert s.shape == (6, tm.geo.n_total) and probs.shape == (2,)
    assert tm.run_clamped(x, [1.0]).shape == (6, tm.geo.n_hidden)
    emb = tm.get_last_hidden_embedding(_images(61, 5).reshape(5, -1), chunk=4)
    assert emb.shape == (5, 3) and ((emb >= 0) & (emb <= 1)).all()
    assert tm.get_num_params() == sum(v.size for v in _leaves(tm.params).values())


# -- weight pickles across packages ---------------------------------------------


def _pickle_model(pkg, learn_penalty, load_path=""):
    kw = dict(seed=6, pooling_type="probabilistic", learn_penalty=learn_penalty,
              load_path=load_path, **BASE)
    return jc.CDQBM(**kw) if pkg == "jax" else tc.CDQBM(device="cpu", **kw)


@pytest.mark.parametrize("src,dst", [("jax", "torch"), ("torch", "jax")])
@pytest.mark.parametrize("learn_penalty", [False, True])
def test_weight_pickles_cross_load(tmp_path, src, dst, learn_penalty):
    a = _pickle_model(src, learn_penalty)
    a.save_weights("w", str(tmp_path))
    objs = pickle.load(open(tmp_path / "w.pkl", "rb"))
    assert len(objs) == (9 if learn_penalty else 8) and objs[0].shape == (3, 3)
    b = _pickle_model(dst, learn_penalty, load_path=str(tmp_path / "w.pkl"))
    _close_tree(b.params, a.params, rtol=0, atol=0)


def test_restricted_and_multichannel_pickles(tmp_path):
    kw = dict(seed=7, is_restricted=True, n_kernels=2, **BASE)
    tc.CDQBM(device="cpu", **kw).save_weights("r", str(tmp_path))
    objs = pickle.load(open(tmp_path / "r.pkl", "rb"))
    assert objs[4] is None and objs[0].shape == (2, 3, 3)
    j = jc.CDQBM(load_path=str(tmp_path / "r.pkl"), **kw)
    assert all(not np.asarray(w).any() for w in j.params.w_seq_intra)
    with pytest.raises(ValueError, match="n_kernels"):
        tc.CDQBM(device="cpu", load_path=str(tmp_path / "r.pkl"), **{**kw, "n_kernels": 1})


def test_reinit_is_a_function_of_seed_and_attempt():
    m = tc.CDQBM(seed=3, device="cpu", **BASE)
    first = _leaves(m.params)
    m.reinit_params(attempt=1)
    second = _leaves(m.params)
    m.reinit_params(attempt=0)
    assert all(np.array_equal(first[k], v) for k, v in _leaves(m.params).items())
    assert not np.array_equal(first["kernel"], second["kernel"])


@pytest.mark.parametrize("seed,attempt", [(0, 0), (7, 0), (3492574433, 3)])
@pytest.mark.parametrize("kw", [
    dict(),
    dict(pooling_type="probabilistic", hidden_bias_type="per-unit", is_restricted=True),
    dict(pooling_type="probabilistic", learn_penalty=True, n_kernels=2, hidden_bias_type="none"),
    dict(pooling_size=0, sequential_layer_sizes=[]),
], ids=["defaults", "probabilistic per-unit restricted", "learned penalty two kernels",
        "no pooling no sequential layer"])
def test_a_model_starts_from_qbmx_parameters(seed, attempt, kw):
    """``CDQBM(seed=s)`` and its ``reinit_params(attempt)`` draw ``qbmx``'s
    parameters for ``(s, attempt)`` bit for bit."""
    kw = {**BASE, **kw}
    t, j = tc.CDQBM(seed=seed, device="cpu", **kw), jc.CDQBM(seed=seed, **kw)
    if attempt:
        t.reinit_params(attempt)
        j.reinit_params(attempt)
    got, want = _leaves(t.params), _leaves(j.params)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# -- coreset --------------------------------------------------------------------


@pytest.mark.parametrize("budget,already", [(12, None), (20, [3, 40, 3]), (2, [5, 6, 7])])
def test_k_center_greedy_matches(budget, already):
    emb = np.random.default_rng(8).normal(size=(120, 6)).astype(np.float32)
    idx = np.arange(1000, 1120)
    got = tcore.k_center_greedy(emb, budget, random_seed=4, index=idx, already_selected=already)
    want = jcore.k_center_greedy(emb, budget, random_seed=4, index=idx, already_selected=already)
    np.testing.assert_array_equal(got, want)


def test_coreset_downsampling():
    x = _images(70, 30)
    y = np.arange(30) % 2

    class Light:
        def get_last_hidden_embedding(self, X):
            return np.asarray(X).reshape(len(X), -1)[:, :5]

    for got, want in zip(tcore.downsample_kcenter_with_light_model(Light(), x, y, 7, 1),
                         jcore.downsample_kcenter_with_light_model(Light(), x, y, 7, 1)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(tcore.random_downsampling(x, y, 9, seed=2),
                         jcore.random_downsampling(x, y, 9, seed=2)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        tcore.random_downsampling(x, y, 31)


# -- the CLI --------------------------------------------------------------------

# synthetic 28×28 images; k=20 and pool 3 keep the QUBO at 95 variables
SMALL = dict(data_set="synthetic", kernel_size=20, pooling_size=3, sample_count=6, anneal=5,
             batch_size=150, epochs=1, device="cpu", pooling_type="probabilistic")


def test_main_runs_end_to_end(tmp_path, capsys):
    save = f"{tmp_path}/"
    acc, f1, precision, recall, auc = tmain.main(save=save, name="run", **SMALL)
    assert all(0.0 <= v <= 1.0 for v in (acc, f1, precision, recall, auc))
    out = capsys.readouterr().out
    assert "QBM created (hidden=94, total=95)" in out and "Epoch 1/1" in out
    run = next(p for p in tmp_path.iterdir() if p.is_dir())
    assert len(pickle.load(open(run / "e1.pkl", "rb"))) == 8
    assert pickle.load(open(tmp_path / "runacc_auc.pkl", "rb"))[0] == acc


def test_main_is_reproducible_from_its_seed():
    kw = {**SMALL, "pooling_type": "deterministic", "coreset_budget": 40}
    assert tmain.main(save="", seed=5, **kw) == tmain.main(save="", seed=5, **kw)


def _flags(parser):
    return {a.dest: (sorted(a.option_strings), a.default) for a in parser._actions}


def test_parser_has_the_reference_flags_and_defaults():
    theirs, ours = _flags(jmain.build_parser()), _flags(tmain.build_parser())
    assert ours.pop("device") == (["--device"], "cuda")
    assert ours == theirs


@pytest.mark.parametrize("kw,err,match", [
    (dict(solver="FujitsuDAU"), NotImplementedError, "annealer-free"),  # refused as in qbmx
    (dict(solver="SA-NATIVE"), None, None),  # ported: it runs
    (dict(solver="Advantage_system4.1"), NotImplementedError, "Ocean"),  # needs the Ocean SDK
    (dict(reinit_on_collapse=2), ValueError, "seed_sweep"),
], ids=[*(f"kw{i}-NotImplementedError-ROADMAP" for i in range(3)), "kw3-ValueError-seed_sweep"])
def test_unported_and_refused_options_raise(kw, err, match):
    if err is None:
        assert all(0.0 <= v <= 1.0 for v in tmain.main(save="", **{**SMALL, **kw}))
        return
    with pytest.raises(err, match=match):
        tmain.main(save="", **{**SMALL, **kw})


@pytest.mark.parametrize("num_classes", [2, 3])
def test_auc_matches_the_reference_definition(num_classes):
    """Binary: positive-class AUC; more classes: the macro one-vs-rest mean
    of the probability columns, as scikit-learn's ``roc_auc_score`` on
    binarized labels computes it."""
    from sklearn.metrics import roc_auc_score
    from sklearn.preprocessing import label_binarize

    rng = np.random.default_rng(num_classes)
    y = np.arange(40) % num_classes
    probs = rng.dirichlet(np.ones(num_classes if num_classes > 2 else 2), 40)
    want = roc_auc_score(y, probs[:, 1]) if num_classes == 2 else roc_auc_score(
        label_binarize(y, classes=list(range(num_classes))), probs, average="macro",
        multi_class="ovr")
    assert tmain.auc_from_probs(y, probs, num_classes) == pytest.approx(want, abs=1e-12)
