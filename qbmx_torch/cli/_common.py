"""Shared CLI helpers: dataset resolution and flag plumbing (counterpart of
``qbmx.cli._common``)."""

from __future__ import annotations

import argparse
import pickle
from pathlib import Path

import numpy as np

from qbmx_torch.data import loaders


def str2bool(v) -> bool:
    """Proper boolean flag parsing (the reference's ``type=bool`` treats any
    non-empty string as True)."""
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "1"):
        return True
    if v.lower() in ("no", "false", "f", "0"):
        return False
    raise argparse.ArgumentTypeError(f"boolean value expected, got {v!r}")


def load_dataset(data_set: str, seed: int = 42, samples_per_class=None,
                 num_classes: int = 2):
    """Resolve a dataset by the reference CLI vocabulary: mnist /
    breastmnist / pneumoniamnist / fashionmnist / cifar-10 / synthetic.  Returns
    (train, val, test) tuples of (images N×H×W, labels N); ``num_classes``
    selects the first N classes of the class-filterable datasets."""
    classes = list(range(num_classes))
    if data_set == "mnist":
        # fall back to an 80/10/10 split of the t10k files when the train
        # images are missing
        try:
            train = loaders.get_mnist(
                "mnist/train-images-idx3-ubyte.gz", "mnist/train-labels-idx1-ubyte.gz",
                classes=classes, samples_per_class=samples_per_class, seed=seed)
            test = loaders.get_mnist(
                "mnist/t10k-images-idx3-ubyte.gz", "mnist/t10k-labels-idx1-ubyte.gz",
                classes=classes, samples_per_class=samples_per_class, seed=seed)
            return train, (None, None), test
        except FileNotFoundError:
            x, y = loaders.get_mnist(
                "mnist/t10k-images-idx3-ubyte.gz", "mnist/t10k-labels-idx1-ubyte.gz",
                classes=classes, samples_per_class=samples_per_class, seed=seed)
            # per-class subsampling concatenates classes in order: shuffle
            # before splitting or the tail split is single-class
            x, y = loaders.shuffle_images(x, y, seed)
            n = len(x)
            a, b = int(0.8 * n), int(0.9 * n)
            return (x[:a], y[:a]), (x[a:b], y[a:b]), (x[b:], y[b:])
    if data_set in ("breastmnist", "pneumoniamnist"):
        return loaders.get_medmnist(f"medmnist/{data_set}.npz", seed=seed)
    if data_set == "fashionmnist":
        train = loaders.get_fashionmnist(
            "fashionmnist/train-images-idx3-ubyte", "fashionmnist/train-labels-idx1-ubyte",
            classes=classes, samples_per_class=samples_per_class, seed=seed)
        test = loaders.get_fashionmnist(
            "fashionmnist/t10k-images-idx3-ubyte", "fashionmnist/t10k-labels-idx1-ubyte",
            classes=classes, samples_per_class=samples_per_class, seed=seed)
        return train, (None, None), test
    if data_set == "cifar-10":
        # classes 3 and 5 (cat, dog) for a binary task
        pick = classes if num_classes != 2 else [3, 5]
        train = loaders.get_cifar10(classes=pick, samples_per_class=samples_per_class or 200,
                                    seed=seed, train=True)
        test = loaders.get_cifar10(classes=pick, samples_per_class=50, seed=seed, train=False)
        return train, (None, None), test
    if data_set == "synthetic":
        x, y = loaders.synthetic_images(800, num_classes=num_classes, seed=seed)
        return (x[:600], y[:600]), (x[600:700], y[600:700]), (x[700:], y[700:])
    raise ValueError(
        f"Invalid dataset {data_set!r}. Options: mnist, breastmnist, "
        "pneumoniamnist, fashionmnist, cifar-10, synthetic"
    )


def qpu_sampler_kwargs(qpu_copies=1, qpu_embedding="first_party", embedding_cache=""):
    """The QPU-seam flags as a ``sampler_kwargs`` dict; ``None`` when every
    flag is at its default."""
    kw = {}
    if qpu_copies > 1:
        kw["copies"] = qpu_copies
    if qpu_embedding != "first_party":
        kw["embedding"] = qpu_embedding
    if embedding_cache:
        kw["cache_dir"] = embedding_cache
    return kw or None


def param_string(**kw) -> str:
    """Run-identity filename encoding (reference ``qbm_main.py:57-58``)."""
    return "".join(f"_{k}{v}" for k, v in kw.items())


def finish_seed_sweep(sweep, seeds, hists, save, name):
    """Shared tail of a ``--seed_sweep`` run: each seed's best-epoch summary,
    the reference-style per-seed acc/auc pickles, the best-epoch weight
    pickles under ``best_model/`` and the mean ± std line.  Returns ``(accs,
    aucs)``, one best-epoch value a seed."""
    from qbmx_torch.train.loop import get_best_combined_acc_auc

    accs, aucs = [], []
    for s, h in zip(seeds, hists):
        _, acc, auc, _ = get_best_combined_acc_auc(h)
        accs.append(acc)
        aucs.append(auc)
        if save:
            out = Path(save)
            out.mkdir(parents=True, exist_ok=True)
            with open(out / f"{name}acc_per_epoch{s}.pkl", "wb") as f:
                pickle.dump(h.acc_per_epoch, f)
            with open(out / f"{name}auc_per_epoch{s}.pkl", "wb") as f:
                pickle.dump(h.auc_per_epoch, f)
        print(f"seed {s}: best acc {acc:.4f} auc {auc:.4f}")
    if save:
        paths = sweep.save_best_models(save, name_fn=lambda s_, e_: f"{name}_se{s_}_e{e_}_best")
        print(f"best-epoch checkpoints: {len(paths)} pickles under {Path(save) / 'best_model'}")
    print(f"MEAN acc {np.mean(accs):.4f}±{np.std(accs):.4f} "
          f"auc {np.mean(aucs):.4f}±{np.std(aucs):.4f}")
    return accs, aucs
