"""The inputs: class-structured synthetic images (a copy of the program's
``data/loaders.synthetic_images``, kept here so that the yardstick does
not move with the program) at a configuration's split sizes, in an order
drawn from the seed, and the warm-up's share of them."""

from __future__ import annotations

import numpy as np


def synthetic_images(n: int, shape=(28, 28), num_classes: int = 2, seed: int = 0):
    """``n`` images in [0, 1): 0.6 of their class's base image plus 0.4 of
    noise, all from ``numpy.random.default_rng(seed)``; and the labels."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, n)
    base = rng.uniform(0.0, 1.0, (num_classes,) + tuple(shape))
    noise = rng.uniform(0.0, 1.0, (n,) + tuple(shape))
    images = 0.6 * base[labels] + 0.4 * noise
    return images.astype("float32"), labels


def make(cfg: dict, seed: int) -> dict:
    """The training and validation splits of a configuration as flat float32
    rows and int64 labels: one set of images a configuration
    (``data.set_seed``), each split in an order drawn from ``seed``, so that
    every seed trains on the same images and does the same work."""
    d = cfg["data"]
    x, y = synthetic_images(d["train"] + d["val"], tuple(d["image_shape"]), d["classes"],
                            d["set_seed"])
    x = x.reshape(len(x), -1)
    y = y.astype(np.int64)
    n = d["train"]
    rng = np.random.default_rng(seed)
    order = np.concatenate([rng.permutation(n), n + rng.permutation(d["val"])])
    x, y = np.ascontiguousarray(x[order]), np.ascontiguousarray(y[order])
    return {"train_X": x[:n], "train_y": y[:n], "val_X": x[n:], "val_y": y[n:]}


def splits(data: dict, t: dict) -> dict:
    """The full splits and the warm-up's (all of either when
    ``warmup_batches`` is unset): its first ``warmup_batches`` whole
    batches and as many rows again as the epoch's partial last batch
    holds, and the first validation chunk and as many rows again as the
    zero-padded last chunk holds, so that the warm-up, and the check that
    judges it, meets the padded batch and the padded chunk every epoch
    runs.  The arrays are made once: the program caches its device copies
    by the identity of the host arrays, so every epoch must pass the same
    ones."""
    out = {"full": (data["train_X"], data["train_y"], data["val_X"], data["val_y"])}
    wb = t.get("warmup_batches")
    if wb is None:
        out["warm"] = out["full"]
    else:
        n, nv, B, chunk = len(data["train_X"]), len(data["val_X"]), t["batch"], t["predict_chunk"]
        rows, vrows = min(wb * B + n % B, n), min(chunk + nv % chunk, nv)
        out["warm"] = tuple(np.ascontiguousarray(a[:k]) for a, k in
                            zip(out["full"], (rows, rows, vrows, vrows)))
    return out
