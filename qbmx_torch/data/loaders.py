"""Dataset ingest in numpy (the subset of ``qbmx.data.loaders`` the flat
Disc_QBM path calls): MNIST idx.gz, FashionMNIST raw idx, MedMNIST .npz,
synthetic images, shuffling and flattening.  Resizing and PCA are not
ported yet (ROADMAP Queue 1 item 8)."""

from __future__ import annotations

import gzip
import os
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


def preprocess_images(train_x, test_x, val_x=None, outputshape=None,
                      pca_n_components=None, do_flatten=True):
    """Flatten the splits; returns (train, test, val)."""
    if outputshape is not None or pca_n_components is not None:
        raise NotImplementedError(
            "qbmx_torch: resize and PCA preprocessing are not ported yet "
            "(ROADMAP Queue 1 item 8)")
    if do_flatten:
        flat = lambda a: (np.ascontiguousarray(np.asarray(a).reshape(len(a), -1))
                          if a is not None else None)
        train_x, test_x, val_x = flat(train_x), flat(test_x), flat(val_x)
    return train_x, test_x, val_x


def shuffle_images(x, y, seed: int = 44):
    if len(x) != len(y):
        raise ValueError("Input data and labels must have the same length.")
    idx = np.random.default_rng(seed).permutation(len(x))
    return np.take(x, idx, axis=0), np.take(np.asarray(y), idx, axis=0)


def synthetic_images(n: int, shape=(28, 28), num_classes: int = 2, seed: int = 0):
    """Class-structured synthetic images for tests and benchmarks."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, n)
    base = rng.uniform(0.0, 1.0, (num_classes,) + shape)
    noise = rng.uniform(0.0, 1.0, (n,) + shape)
    images = 0.6 * base[labels] + 0.4 * noise
    return images.astype("float32"), labels
