"""Dataset files in their real on-disk byte formats, synthesized from
seeds (counterpart of ``qbmx.data.synthesize``, byte for byte).

The reference tree ships FashionMNIST/MNIST *label* files without the
large image blobs, and no CIFAR-10 archive.  To drive the loaders and
CLIs over the actual byte formats, these helpers write:

  * idx1/idx3 files (the MNIST/FashionMNIST format: big-endian magic + dims
    header, uint8 payload — what ``src/data_loader.py:23-73`` parses), with
    class-templated images keyed to real label streams when provided, and
  * ``cifar-10-batches-py`` python-pickle batches (``data`` (N, 3072) uint8
    row-major RGB + ``labels``), the stock layout ``loaders.get_cifar10``
    reads.

Images are deterministic class templates + noise, so classifiers can
genuinely learn from them; labels can come from the reference's real label
files to keep the label-parsing path honest.
"""

from __future__ import annotations

import pickle
import struct
from pathlib import Path

import numpy as np


def class_template_images(labels, shape=(28, 28), num_classes: int = 10,
                          seed: int = 0, noise_seed: int | None = None) -> np.ndarray:
    """(N, *shape) uint8 images: fixed per-class template + pixel noise.

    ``seed`` fixes the class TEMPLATES (must be shared between train and
    test splits or the task is unlearnable); ``noise_seed`` varies the
    per-image noise (defaults to ``seed``)."""
    base = np.random.default_rng(seed).uniform(0.0, 1.0, (num_classes,) + tuple(shape))
    rng = np.random.default_rng(seed if noise_seed is None else noise_seed)
    labels = np.asarray(labels, dtype=int)
    noise = rng.uniform(0.0, 1.0, (len(labels),) + tuple(shape))
    imgs = 0.7 * base[labels % num_classes] + 0.3 * noise
    return (imgs * 255).astype(np.uint8)


def write_idx3(path, images: np.ndarray) -> Path:
    """uint8 (N, H, W) → idx3 file (magic 2051)."""
    images = np.asarray(images, dtype=np.uint8)
    n, h, w = images.shape
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, h, w))
        f.write(images.tobytes())
    return path


def write_idx1(path, labels: np.ndarray) -> Path:
    """uint8 (N,) → idx1 file (magic 2049)."""
    labels = np.asarray(labels, dtype=np.uint8)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(struct.pack(">II", 2049, len(labels)))
        f.write(labels.tobytes())
    return path


def read_idx1(path) -> np.ndarray:
    with open(path, "rb") as f:
        return np.frombuffer(f.read(), "B", offset=8)


def synthesize_fashionmnist(dst_dir, labels_train=None, labels_test=None,
                            max_train: int = 4000, max_test: int = 1000,
                            seed: int = 0) -> Path:
    """Write a complete fashionmnist/ directory (images + labels, idx
    format).  Real label streams (e.g. read from the reference tree with
    :func:`read_idx1`) are truncated to ``max_*`` and used verbatim;
    synthetic labels are drawn when none are given."""
    rng = np.random.default_rng(seed)
    if labels_train is None:
        labels_train = rng.integers(0, 10, max_train).astype(np.uint8)
    if labels_test is None:
        labels_test = rng.integers(0, 10, max_test).astype(np.uint8)
    labels_train = np.asarray(labels_train)[:max_train]
    labels_test = np.asarray(labels_test)[:max_test]
    d = Path(dst_dir) / "fashionmnist"
    write_idx1(d / "train-labels-idx1-ubyte", labels_train)
    write_idx1(d / "t10k-labels-idx1-ubyte", labels_test)
    write_idx3(d / "train-images-idx3-ubyte",
               class_template_images(labels_train, seed=seed, noise_seed=seed + 1))
    write_idx3(d / "t10k-images-idx3-ubyte",
               class_template_images(labels_test, seed=seed, noise_seed=seed + 2))
    return d


def synthesize_cifar10(dst_dir, n_per_train_batch: int = 400,
                       n_test: int = 500, seed: int = 0) -> Path:
    """Write a stock-layout ``cifar-10-batches-py`` directory."""
    rng = np.random.default_rng(seed)
    d = Path(dst_dir) / "cifar-10-batches-py"
    d.mkdir(parents=True, exist_ok=True)

    def make_batch(n, s):
        labels = rng.integers(0, 10, n)
        imgs = class_template_images(labels, shape=(3, 32, 32), seed=seed,
                                     noise_seed=s)
        return {b"data": imgs.reshape(n, 3072), b"labels": labels.tolist()}

    for i in range(1, 6):
        with open(d / f"data_batch_{i}", "wb") as f:
            pickle.dump(make_batch(n_per_train_batch, seed + i), f)
    with open(d / "test_batch", "wb") as f:
        pickle.dump(make_batch(n_test, seed + 99), f)
    return d
