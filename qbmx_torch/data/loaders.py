"""Dataset ingest in numpy (counterpart of ``qbmx.data.loaders``): MNIST
idx.gz, FashionMNIST raw idx, MedMNIST .npz, CIFAR-10 python batches,
synthetic images, shuffling, balancing, binarizing, resizing, flattening
and PCA.

Two helpers compute in numpy what ``qbmx`` hands to a library:
``resize_images`` builds ``jax.image.resize``'s separable triangle-kernel
weights (linear, antialiased) and applies one contraction an axis, and the
PCA of ``preprocess_images`` is a centred SVD with scikit-learn's sign
rule, exact at every shape (scikit-learn switches to a randomized solver
on larger inputs, ROADMAP Queue 3)."""

from __future__ import annotations

import gzip
import os
import pickle
from pathlib import Path

import numpy as np

_KNOWN_SUBDIRS = ("mnist", "fashionmnist", "medmnist")


def _data_root_candidates() -> tuple[str, ...]:
    return (os.environ.get("QBMX_DATA_DIR", ""), "data", "src/data")


def find_data_root() -> Path | None:
    """First existing dataset root: ``$QBMX_DATA_DIR``, ``./data``, ``./src/data``."""
    for cand in _data_root_candidates():
        if cand and Path(cand).is_dir():
            return Path(cand)
    return None


def _resolve(path: str) -> str:
    """Find a dataset file across every candidate root.  When the path
    names a dataset subdir (e.g. ``fashionmnist/train-images-idx3-ubyte``)
    only that subdir is searched: MNIST and FashionMNIST share bare file
    names."""
    if Path(path).exists():
        return path
    rel = Path(path)
    hint = rel.parent.name if rel.parent.name in _KNOWN_SUBDIRS else None
    for cand in _data_root_candidates():
        if not cand or not Path(cand).is_dir():
            continue
        for sub in (hint,) if hint else ("",) + _KNOWN_SUBDIRS:
            p = Path(cand) / sub / rel.name
            if p.exists():
                return str(p)
    raise FileNotFoundError(path)


def _subsample_per_class(images, labels, samples_per_class, seed):
    """A class with fewer than ``samples_per_class`` examples is taken whole."""
    rng = np.random.default_rng(seed)
    sel_x, sel_y = [], []
    for cls in np.unique(labels):
        idx = np.where(labels == cls)[0]
        pick = rng.choice(idx, size=min(samples_per_class, len(idx)), replace=False)
        sel_x.append(images[pick])
        sel_y.append(labels[pick])
    return np.concatenate(sel_x), np.concatenate(sel_y)


def _finish_classification(images, labels, classes, size, samples_per_class, seed):
    if classes is not None:
        mask = np.isin(labels, classes)
        images, labels = images[mask], labels[mask]
    if samples_per_class is not None:
        images, labels = _subsample_per_class(images, labels, samples_per_class, seed)
    if size is not None:
        idx = np.random.default_rng(seed).permutation(len(images))[:size]
        images, labels = images[idx], labels[idx]
    if classes is not None and len(classes) == 2:
        labels = np.asarray([0 if l == classes[0] else 1 for l in labels])
    return images, np.asarray(labels)


def _read_idx(file_image, file_labels, opener):
    with opener(_resolve(file_image), "rb") as f:
        images = np.frombuffer(f.read(), "B", offset=16).reshape(-1, 28, 28).astype("float32") / 255
    with opener(_resolve(file_labels), "rb") as f:
        labels = np.frombuffer(f.read(), "B", offset=8)
    return images, labels


def get_mnist(file_image: str, file_labels: str, classes=None, size=None,
              samples_per_class=None, seed: int = 42):
    """idx.gz MNIST files → (images (N, 28, 28) in [0,1], labels)."""
    images, labels = _read_idx(file_image, file_labels, gzip.open)
    return _finish_classification(images, labels, classes, size, samples_per_class, seed)


def get_fashionmnist(file_image: str, file_labels: str, classes=None, size=None,
                     samples_per_class=None, seed: int = 42):
    """Raw (uncompressed) idx FashionMNIST files."""
    images, labels = _read_idx(file_image, file_labels, open)
    return _finish_classification(images, labels, classes, size, samples_per_class, seed)


def get_medmnist(file: str, index: int = 0, duplicate_positives_n_times: int = 0,
                 do_balance: bool = False, size=None, seed: int = 42):
    """MedMNIST .npz → ((train_x, train_y), (val_x, val_y), (test_x, test_y))."""
    data = np.load(_resolve(file))
    rng = np.random.default_rng(seed)

    train_x = data["train_images"].astype("float32") / 255
    val_x = data["val_images"].astype("float32") / 255
    test_x = data["test_images"].astype("float32") / 255
    train_y = data["train_labels"][:, index]
    val_y = data["val_labels"][:, index]
    test_y = data["test_labels"][:, index]

    if size is not None:
        sel_x, sel_y = [], []
        for cls, cls_size in enumerate(size):
            idx = np.where(train_y == cls)[0]
            pick = rng.choice(idx, size=cls_size, replace=len(idx) < cls_size)
            sel_x.append(train_x[pick])
            sel_y.append(train_y[pick])
        train_x, train_y = np.concatenate(sel_x), np.concatenate(sel_y)

    if duplicate_positives_n_times > 0:
        pos = np.where(train_y == 1)[0]
        for _ in range(duplicate_positives_n_times):
            train_x = np.concatenate([train_x, train_x[pos]])
            train_y = np.concatenate([train_y, train_y[pos]])

    if do_balance:
        pos = np.where(train_y == 1)[0]
        neg = np.where(train_y == 0)[0]
        pick_neg = rng.choice(neg, len(pos))
        train_x = np.concatenate([train_x[pos], train_x[pick_neg]])
        train_y = np.concatenate([train_y[pos], train_y[pick_neg]])

    return (train_x, train_y), (val_x, val_y), (test_x, test_y)


def balance_by_undersampling(train_images, train_labels, seed: int = 42):
    """Random-undersample the majority class to the minority size."""
    rng = np.random.default_rng(seed)
    pos = np.where(train_labels == 1)[0]
    neg = np.where(train_labels == 0)[0]
    if len(pos) == len(neg):
        return train_images, train_labels
    major, minor = (pos, neg) if len(pos) > len(neg) else (neg, pos)
    major = rng.permutation(major)[: len(minor)]
    idx = rng.permutation(np.concatenate([minor, major]))
    return train_images[idx], train_labels[idx]


def _resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) float32 weights of one axis of
    ``jax.image.resize(method="linear", antialias=True)``: a triangle
    kernel widened by the downsampling factor, each output's weights
    normalised to sum 1, zero for an output centred outside the input
    (``compute_weight_mat`` of ``jax.image``, translation 0)."""
    f32 = np.float32
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = f32(max(inv_scale, 1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * f32(inv_scale) - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0), f32(1) - np.abs(x))
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                 w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0)).astype(f32)


def resize_images(images, outputshape):
    """Anti-aliased linear resize of an (N, H, W[, C]) image stack to
    ``outputshape`` (H', W'): ``qbmx``'s ``jax.image.resize(method="linear",
    antialias=True)``, as one weight contraction per resized axis."""
    a = np.asarray(images, dtype=np.float32)
    if a.ndim < 3:
        raise ValueError(f"resize needs (N, H, W[, C]) images, got {a.shape}")
    for axis, size in zip((1, 2), outputshape):
        if a.shape[axis] != size:
            w = _resize_weights(a.shape[axis], size)
            a = np.moveaxis(np.tensordot(a, w, axes=([axis], [0])), -1, axis)
    return np.ascontiguousarray(a, dtype=np.float32)


def pca_fit(x, n_components: int):
    """(mean, components (k, D), projection of ``x``) of a PCA fitted on
    ``x`` (N, D): a centred SVD, each component's sign set so that its
    largest-magnitude entry is positive (scikit-learn's ``svd_flip`` on
    the rows of Vt, as its PCA applies it)."""
    x = np.asarray(x)
    if not 1 <= n_components <= min(x.shape):
        raise ValueError(f"n_components={n_components} must be between 1 and "
                         f"min(n_samples, n_features)={min(x.shape)}")
    mean = x.mean(axis=0)
    u, s, vt = np.linalg.svd(x - mean, full_matrices=False)
    signs = np.sign(vt[np.arange(len(vt)), np.argmax(np.abs(vt), axis=1)])
    u, vt = u * signs, vt * signs[:, None]
    return mean, vt[:n_components], u[:, :n_components] * s[:n_components]


def preprocess_images(train_x, test_x, val_x=None, outputshape=None,
                      pca_n_components=None, do_flatten=True):
    """Resize (``outputshape=(H', W')``), flatten, and PCA-project
    (``pca_n_components``, fitted on the train split) the splits; returns
    (train, test, val)."""
    each = lambda fn, *splits: tuple(fn(a) if a is not None else None for a in splits)
    if outputshape is not None:
        train_x, test_x, val_x = each(lambda a: resize_images(a, outputshape),
                                      train_x, test_x, val_x)
    if do_flatten:
        train_x, test_x, val_x = each(
            lambda a: np.ascontiguousarray(np.asarray(a).reshape(len(a), -1)),
            train_x, test_x, val_x)
    if pca_n_components is not None:
        mean, comps, train_x = pca_fit(train_x, pca_n_components)
        test_x, val_x = each(lambda a: (np.asarray(a) - mean) @ comps.T, test_x, val_x)
    return train_x, test_x, val_x


def shuffle_images(x, y, seed: int = 44):
    if len(x) != len(y):
        raise ValueError("Input data and labels must have the same length.")
    idx = np.random.default_rng(seed).permutation(len(x))
    return np.take(x, idx, axis=0), np.take(np.asarray(y), idx, axis=0)


def encode_labels_to_onehot(labels, num_classes: int):
    return np.eye(num_classes)[np.asarray(labels, dtype=int)]


def reshape_pad_and_flatten(images, original_shape, pad: int):
    """Reshape flat images to (H, W), zero-pad, return padded image stack."""
    H, W = original_shape
    images = np.asarray(images).reshape((-1, H, W))
    return np.pad(images, ((0, 0), (pad, pad), (pad, pad)), mode="constant")


def get_cifar10(data_dir: str = "cifar-10-batches-py", classes=None, size=None,
                samples_per_class=None, seed: int = 42, train: bool = True,
                grayscale: bool = True):
    """CIFAR-10 from the standard python-pickle batches on disk (searched
    under every data root), grayscaled to (N, 32, 32) by ITU-R 601 luma
    (or (N, 32, 32, 3) colour)."""
    root = Path(data_dir)
    if not root.is_dir():
        for cand in _data_root_candidates():
            if cand and (Path(cand) / data_dir).is_dir():
                root = Path(cand) / data_dir
                break
        else:
            raise FileNotFoundError(data_dir)
    files = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
    imgs, labels = [], []
    for name in files:
        with open(root / name, "rb") as f:
            d = pickle.load(f, encoding="bytes")
        imgs.append(np.asarray(d[b"data"], dtype="float32") / 255)
        labels.append(np.asarray(d[b"labels"]))
    images = np.concatenate(imgs).reshape(-1, 3, 32, 32)
    labels = np.concatenate(labels)
    if grayscale:
        images = 0.299 * images[:, 0] + 0.587 * images[:, 1] + 0.114 * images[:, 2]
    else:
        images = images.transpose(0, 2, 3, 1)
    return _finish_classification(images, labels, classes, size, samples_per_class, seed)


def binarize(x, threshold: float = 0.5):
    """Binarize [0,1] pixel intensities (the CD-k benchmark's ingest step)."""
    return (np.asarray(x) > threshold).astype("float32")


def synthetic_images(n: int, shape=(28, 28), num_classes: int = 2, seed: int = 0):
    """Class-structured synthetic images for tests and benchmarks."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, n)
    base = rng.uniform(0.0, 1.0, (num_classes,) + shape)
    noise = rng.uniform(0.0, 1.0, (n,) + shape)
    images = 0.6 * base[labels] + 0.4 * noise
    return images.astype("float32"), labels
