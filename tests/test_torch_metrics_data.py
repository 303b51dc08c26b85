"""The port's numpy metrics against qbmx.utils.metrics (scikit-learn), and its
data helpers against qbmx.data.loaders.  Metrics agree within 1e-12 (both
in float64); data helpers are identical."""

from __future__ import annotations

import gzip
import pickle

import numpy as np
import pytest

import qbmx.cli._common as jcommon
import qbmx.data.loaders as jl
import qbmx.utils.metrics as jm
import qbmx_torch.cli._common as tcommon
import qbmx_torch.data.loaders as tl
import qbmx_torch.utils.metrics as tm

rng = np.random.default_rng(0)
LABELS = {
    "binary": (rng.integers(0, 2, 40), rng.integers(0, 2, 40)),
    "all_wrong": (np.asarray([0, 1, 1, 0]), np.asarray([1, 0, 0, 1])),
    "no_positive_pred": (np.asarray([0, 1, 1, 0]), np.zeros(4, int)),
    "single_class_true": (np.ones(6, int), np.asarray([1, 0, 1, 1, 0, 1])),
    "multiclass": (rng.integers(0, 4, 50), rng.integers(0, 4, 50)),
    "multiclass_missing_pred": (np.asarray([0, 1, 2, 2, 1]), np.asarray([0, 0, 2, 2, 0])),
}


@pytest.mark.parametrize("case", sorted(LABELS))
def test_get_metrics_matches(case):
    y, p = LABELS[case]
    titles = ["0", "1"] if case in ("binary", "all_wrong", "no_positive_pred",
                                    "single_class_true") else [str(i) for i in range(4)]
    ours, theirs = tm.get_metrics(y, p, titles), jm.get_metrics(y, p, titles)
    if case == "single_class_true":
        # AUC is undefined: the port returns 0.0 (qbmx's documented rule);
        # qbmx gets 0.0 from scikit-learn versions that raise there and nan
        # from those that warn
        assert ours[-1] == 0.0 and (theirs[-1] == 0.0 or np.isnan(theirs[-1]))
        ours, theirs = ours[:-1], theirs[:-1]
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-12)


@pytest.mark.parametrize("case", ["binary", "binary_ties", "single_class",
                                  "multiclass", "multiclass_missing"])
def test_prob_scored_auc_matches(case):
    r = np.random.default_rng(1)
    y = r.integers(0, 2, 30)
    probs = r.random((30, 2))
    if case == "binary_ties":
        probs = np.round(probs, 1)
    elif case == "single_class":
        y = np.zeros(30, int)
    elif case.startswith("multiclass"):
        y = r.integers(0, 3, 30) if case == "multiclass" else r.integers(0, 2, 30)
        probs = r.random((30, 3))
    np.testing.assert_allclose(tm.prob_scored_auc(y, probs), jm.prob_scored_auc(y, probs),
                               rtol=0, atol=1e-12)


def test_result_text_and_files_match(tmp_path):
    class M:
        dim_input, n_output_nodes, n_hidden_nodes, beta_eff = 784, 1, 5, 1.0

    y, p = LABELS["binary"]
    hist = {}
    for pkg, mod in (("jax", jm), ("torch", tm)):
        h = mod.History(nll_per_batch=[0.5, 0.25], acc_per_epoch=[0.75], auc_per_epoch=[0.7])
        out = mod.save_result(str(tmp_path / pkg / "run"), M(), h, [np.ones(2)], y, p,
                              ["0", "1"], 60, 1, "SA", 0.3)
        text = (tmp_path / pkg / "run_result.txt").read_text()
        hist[pkg] = (out, text.splitlines(), sorted(f.name for f in (tmp_path / pkg).iterdir()))
    assert hist["jax"][2] == hist["torch"][2]
    np.testing.assert_allclose(hist["jax"][0], hist["torch"][0], rtol=0, atol=1e-12)
    for ours, theirs in zip(hist["torch"][1], hist["jax"][1], strict=True):
        key, _, value = ours.partition(": ")
        assert theirs.startswith(key + ": ")
        if key == "AUC ROC score":  # the last digit may differ
            assert abs(float(value) - float(theirs[len(key) + 2:])) < 1e-12
        else:
            assert ours == theirs
    for pkg in ("jax", "torch"):
        assert pickle.load(open(tmp_path / pkg / "runnll_per_batch.pkl", "rb")) == [0.5, 0.25]
    assert pickle.load(open(tmp_path / "torch" / "runacc_auc.pkl", "rb"))[0] == hist["torch"][0][0]


def test_history_fields_match():
    assert tm.History().__dataclass_fields__.keys() == jm.History().__dataclass_fields__.keys()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_history_written_by_either_package_loads_in_both(tmp_path, writer):
    """Every series ``save_history`` writes reads back equal through both
    packages' ``load_history``; a missing series reads as ``[]``."""
    mod = jm if writer == "jax" else tm
    h = mod.History(errors_per_batch=[0.0, 0.5], error_per_epoch=[0.25],
                    nll_per_batch=[0.5, 0.25], nll_per_epoch=[0.375], acc_per_epoch=[0.75],
                    auc_per_epoch=[0.7], combined_acc_auc_per_epoch=[0.725])
    prefix = str(tmp_path / "run")
    mod.save_history(prefix, h)
    (tmp_path / "runauc_per_epoch.pkl").unlink()  # a series absent on disk
    ours, theirs = tm.load_history(prefix), jm.load_history(prefix)
    for field in ("errors_per_batch", "error_per_epoch", "nll_per_batch", "nll_per_epoch",
                  "acc_per_epoch", "auc_per_epoch", "combined_acc_auc_per_epoch"):
        want = [] if field == "auc_per_epoch" else getattr(h, field)
        assert getattr(ours, field) == getattr(theirs, field) == want, field
    assert tm.load_history(str(tmp_path / "absent")) == tm.History()


# -- data ---------------------------------------------------------------------


@pytest.mark.parametrize("num_classes", [2, 3])
def test_synthetic_and_load_dataset_match(num_classes):
    for a, b in zip(tl.synthetic_images(50, num_classes=num_classes, seed=4),
                    jl.synthetic_images(50, num_classes=num_classes, seed=4)):
        np.testing.assert_array_equal(a, b)
    ours = tcommon.load_dataset("synthetic", seed=9, num_classes=num_classes)
    theirs = jcommon.load_dataset("synthetic", seed=9, num_classes=num_classes)
    for split_ours, split_theirs in zip(ours, theirs):
        for a, b in zip(split_ours, split_theirs):
            np.testing.assert_array_equal(a, b)


def test_shuffle_and_preprocess_match():
    x, y = tl.synthetic_images(12, seed=1)
    for a, b in zip(tl.shuffle_images(x, y, 3), jl.shuffle_images(x, y, 3)):
        np.testing.assert_array_equal(a, b)
    ours = tl.preprocess_images(x[:8], x[8:], x[4:6])
    theirs = jl.preprocess_images(x[:8], x[8:], x[4:6])
    for a, b in zip(ours, theirs):
        assert a.flags["C_CONTIGUOUS"]
        np.testing.assert_array_equal(a, b)
    assert tl.preprocess_images(x, x)[2] is None
    # resize and PCA, ported: against jax.image.resize and scikit-learn
    # within 1e-4 of the output's scale (8 rows of 784: scikit-learn's
    # randomized solver spans the whole row space, so it is exact here)
    for kw in (dict(outputshape=(14, 14)), dict(pca_n_components=3)):
        for a, b in zip(tl.preprocess_images(x[:8], x[8:], x[4:6], **kw),
                        jl.preprocess_images(x[:8], x[8:], x[4:6], **kw)):
            assert a.shape == b.shape and a.dtype == np.float32
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * max(1.0, np.abs(b).max()))
    with pytest.raises(ValueError):
        tl.shuffle_images(x, y[:3])


def _idx_files(tmp_path, opener, suffix):
    r = np.random.default_rng(2)
    images = r.integers(0, 256, (30, 28, 28), dtype=np.uint8)
    labels = r.integers(0, 4, 30).astype(np.uint8)
    img, lab = tmp_path / f"img{suffix}", tmp_path / f"lab{suffix}"
    with opener(img, "wb") as f:
        f.write(b"\0" * 16 + images.tobytes())
    with opener(lab, "wb") as f:
        f.write(b"\0" * 8 + labels.tobytes())
    return str(img), str(lab)


@pytest.mark.parametrize("kw", [dict(), dict(classes=[1, 3]), dict(classes=[0, 1, 2], size=10),
                                dict(classes=[0, 2], samples_per_class=4, seed=5)])
def test_idx_loaders_match(tmp_path, kw):
    for fn, opener, suffix in (("get_mnist", gzip.open, ".gz"), ("get_fashionmnist", open, "")):
        files = _idx_files(tmp_path, opener, suffix)
        for a, b in zip(getattr(tl, fn)(*files, **kw), getattr(jl, fn)(*files, **kw)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [dict(), dict(size=[5, 7]), dict(duplicate_positives_n_times=2),
                                dict(do_balance=True, seed=3)])
def test_get_medmnist_matches(tmp_path, kw):
    r = np.random.default_rng(3)
    split = lambda n: (r.integers(0, 256, (n, 28, 28), dtype=np.uint8),
                       r.integers(0, 2, (n, 1)))
    arrays = {}
    for name, n in (("train", 40), ("val", 10), ("test", 12)):
        arrays[f"{name}_images"], arrays[f"{name}_labels"] = split(n)
    np.savez(tmp_path / "breastmnist.npz", **arrays)
    path = str(tmp_path / "breastmnist.npz")
    for split_ours, split_theirs in zip(tl.get_medmnist(path, **kw), jl.get_medmnist(path, **kw)):
        for a, b in zip(split_ours, split_theirs):
            np.testing.assert_array_equal(a, b)


def test_resolve_searches_the_data_roots(tmp_path, monkeypatch):
    (tmp_path / "medmnist").mkdir()
    (tmp_path / "medmnist" / "x.npz").write_bytes(b"")
    monkeypatch.setenv("QBMX_DATA_DIR", str(tmp_path))
    assert tl.find_data_root() == tmp_path
    assert tl._resolve("medmnist/x.npz") == str(tmp_path / "medmnist" / "x.npz")
    assert tl._resolve("x.npz") == str(tmp_path / "medmnist" / "x.npz")
    with pytest.raises(FileNotFoundError):
        tl._resolve("mnist/x.npz")  # a subdir hint searches only that subdir


def test_cli_helpers_match():
    for v in ("yes", "False", "t", "0", True):
        assert tcommon.str2bool(v) == jcommon.str2bool(v)
    kw = dict(se=1, h=5, sol="SA", r=False)
    assert tcommon.param_string(**kw) == jcommon.param_string(**kw)
    for args in ((1, "first_party", ""), (3, "composite", "cache")):
        assert tcommon.qpu_sampler_kwargs(*args) == jcommon.qpu_sampler_kwargs(*args)
    with pytest.raises(ValueError, match="Invalid dataset"):
        tcommon.load_dataset("nope")


# -- the rest of qbmx.data.loaders: balancing, labels, padding, binarizing,
# resizing, PCA and CIFAR-10 (numpy copies equal; resize and PCA computed
# here in numpy where qbmx calls jax and scikit-learn)


@pytest.mark.parametrize("counts", [(7, 12), (12, 7), (5, 5), (0, 4)])
def test_balance_by_undersampling_matches(counts):
    r = np.random.default_rng(sum(counts))
    labels = r.permutation(np.repeat([1, 0], counts))
    images = r.random((len(labels), 3, 3)).astype(np.float32)
    for a, b in zip(tl.balance_by_undersampling(images, labels, seed=4),
                    jl.balance_by_undersampling(images, labels, seed=4)):
        np.testing.assert_array_equal(a, b)


def test_label_padding_and_binarize_helpers_match():
    r = np.random.default_rng(6)
    labels = r.integers(0, 4, 9)
    np.testing.assert_array_equal(tl.encode_labels_to_onehot(labels, 4),
                                  jl.encode_labels_to_onehot(labels, 4))
    flat = r.random((5, 12)).astype(np.float32)
    np.testing.assert_array_equal(tl.reshape_pad_and_flatten(flat, (3, 4), 2),
                                  jl.reshape_pad_and_flatten(flat, (3, 4), 2))
    for thr in (0.5, 0.25):
        a, b = tl.binarize(flat, thr), jl.binarize(flat, thr)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape,out", [((3, 28, 28), (14, 14)), ((2, 28, 28), (16, 9)),
                                       ((2, 8, 12), (12, 20)), ((2, 32, 32, 3), (16, 16)),
                                       ((2, 10, 10), (10, 7)), ((1, 7, 5), (7, 5))])
def test_resize_images_matches_jax_image_resize(shape, out):
    """Downsampling (antialiased), upsampling, one axis only, channels and
    the identity, within 1e-6 of ``jax.image.resize(method="linear",
    antialias=True)`` (the weights are built alike in float32; the
    contractions sum in another order)."""
    images = np.random.default_rng(len(shape)).random(shape).astype(np.float32)
    got, want = tl.resize_images(images, out), jl.resize_images(images, out)
    assert got.shape == want.shape == (shape[0], *out, *shape[3:]) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="N, H, W"):
        tl.resize_images(images[0, 0], out)


def _low_rank(n, d, k, seed):
    """(n, d) data with k well-separated principal directions plus noise."""
    r = np.random.default_rng(seed)
    latent = r.normal(size=(n, k)) * (3.0 * 0.6 ** np.arange(k))
    return (latent @ r.normal(size=(k, d)) + 0.05 * r.normal(size=(n, d)) + 1.0).astype(np.float32)


@pytest.mark.parametrize("n,d,k", [(60, 20, 3), (300, 400, 5), (400, 30, 4)],
                         ids=["full small", "full at 400", "covariance_eigh (tall)"])
def test_pca_matches_scikit_learn_where_it_is_exact(n, d, k):
    """At shapes where scikit-learn's ``svd_solver="auto"`` picks an exact
    solver (``full`` up to 500 rows and columns, ``covariance_eigh`` for
    tall data of ≤ 1000 features), each projected component equals
    scikit-learn's up to its sign, within 1e-4 of its scale; the
    components themselves carry scikit-learn's sign rule."""
    from sklearn.decomposition import PCA

    x = _low_rank(n, d, k, seed=n)
    test = _low_rank(20, d, k, seed=n)
    pca = PCA(n_components=k)
    want_train, want_test = pca.fit_transform(x), pca.transform(test)
    assert pca._fit_svd_solver in ("full", "covariance_eigh")
    mean, comps, got_train = tl.pca_fit(x, k)
    np.testing.assert_allclose(mean, pca.mean_, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.abs(comps), np.abs(pca.components_), rtol=0, atol=1e-4)
    signs = np.sign(np.sum(comps * pca.components_, axis=1))
    assert np.all(signs == 1.0)  # the same sign rule
    got_test = tl.preprocess_images(x, test, pca_n_components=k)[1]
    for got, want in ((got_train, want_train), (got_test, want_test)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    with pytest.raises(ValueError, match="n_components"):
        tl.pca_fit(x, min(n, d) + 1)


def test_scikit_learn_pca_turns_randomized_past_500():
    """The known defect of qbmx's PCA (ROADMAP Queue 3): from more than 500
    rows or columns with fewer components than 0.8 of the smaller side
    (unless the data is tall enough for ``covariance_eigh``), scikit-learn
    picks its randomized solver, an approximation whose draws come from
    numpy's global stream. The port's SVD stays exact there."""
    from sklearn.decomposition import PCA

    for shape, solver in (((546, 784), "randomized"), ((500, 500), "full"),
                          ((501, 400), "randomized"), ((8000, 784), "covariance_eigh")):
        pca = PCA(n_components=10).fit(_low_rank(*shape, 3, seed=1))
        assert pca._fit_svd_solver == solver, shape


def test_get_cifar10_and_load_dataset_match(tmp_path, monkeypatch):
    """Over the stock-layout batches ``qbmx_torch/data/synthesize.py``
    writes: the loader (grayscale, colour, class filters, subsampling) and
    the CLI's ``cifar-10`` branch equal qbmx's; absent files raise."""
    from qbmx_torch.data.synthesize import synthesize_cifar10

    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError):
        tl.get_cifar10()
    root = synthesize_cifar10(tmp_path / "data", n_per_train_batch=60, n_test=80, seed=2)
    for kw in (dict(), dict(grayscale=False, train=False), dict(classes=[3, 5], size=50),
               dict(classes=[1, 2, 7], samples_per_class=6, seed=9)):
        got, want = tl.get_cifar10(**kw), jl.get_cifar10(str(root), **kw)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert tl.get_cifar10()[0].shape[1:] == (32, 32)
    for num_classes in (2, 3):
        ours = tcommon.load_dataset("cifar-10", seed=4, num_classes=num_classes)
        theirs = jcommon.load_dataset("cifar-10", seed=4, num_classes=num_classes)
        for split_ours, split_theirs in zip(ours, theirs):
            for a, b in zip(split_ours, split_theirs):
                np.testing.assert_array_equal(a, b)


# -- synthesized datasets -------------------------------------------------------


@pytest.mark.parametrize("real_labels", [False, True])
def test_synthesized_files_are_byte_equal_and_load_in_both(tmp_path, real_labels):
    """``qbmx_torch.data.synthesize`` writes the bytes ``qbmx``'s writes for
    the same seeds and labels (FashionMNIST idx files, CIFAR-10 batches),
    and the loaders of both packages read either copy equal."""
    import qbmx.data.synthesize as js
    import qbmx_torch.data.synthesize as ts

    labels = dict(labels_train=np.arange(30) % 10, labels_test=np.arange(12)[::-1] % 10) \
        if real_labels else {}
    for pkg, mod in (("jax", js), ("torch", ts)):
        mod.synthesize_fashionmnist(tmp_path / pkg, max_train=25, max_test=9, seed=3, **labels)
        mod.synthesize_cifar10(tmp_path / pkg, n_per_train_batch=7, n_test=5, seed=4)
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*")
                   if p.is_file())
    assert len(files) == 10
    for f in files:
        assert (tmp_path / "torch" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
    d = tmp_path / "torch" / "fashionmnist"
    np.testing.assert_array_equal(ts.read_idx1(d / "t10k-labels-idx1-ubyte"),
                                  js.read_idx1(d / "t10k-labels-idx1-ubyte"))
    img, lab = str(d / "train-images-idx3-ubyte"), str(d / "train-labels-idx1-ubyte")
    for a, b in zip(tl.get_fashionmnist(img, lab), jl.get_fashionmnist(img, lab)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ts.class_template_images([1, 2], seed=5),
                                  js.class_template_images([1, 2], seed=5))
