"""Model base (counterpart of ``qbmx.models.base``): the weight-pickle
format shared with ``qbmx``, small parameter-tree helpers, the model
protocol, and whole-epoch training over device-cached batches."""

from __future__ import annotations

import abc
import dataclasses
import pickle
import weakref
from pathlib import Path

import numpy as np
import torch

from qbmx_torch.utils.spans import span


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing a CUDA device that is not there:
    a model or CLI asked for the card never carries on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r}: no CUDA device is available "
                           "(pass device='cpu' / --device cpu to run the plain PyTorch path)")
    return dev


def save_weight_pickle(objs: list, title: str, path: str = "out") -> None:
    """Write a reference-format weight list pickle (``<path>/<title>.pkl``,
    the list as given: numpy arrays, lists of them and ``None`` — the format
    ``qbmx`` reads and writes)."""
    Path(path).mkdir(parents=True, exist_ok=True)
    with open(f"{path}/{title}.pkl", "wb") as f:
        pickle.dump(list(objs), f)


def load_weight_pickle(file_path, missing_msg: str = "params file not found"):
    """Read a weight-list pickle, raising ``FileNotFoundError(missing_msg)``
    when absent."""
    file_path = Path(file_path)
    if not file_path.exists():
        raise FileNotFoundError(missing_msg)
    with open(file_path, "rb") as f:
        return pickle.load(f)


def tree_map(fn, *trees):
    """Apply ``fn`` leaf-wise over parameter trees of one structure:
    dataclasses of tensors, tuples of tensors (per-layer weights) and
    ``None`` (an absent optional parameter, left as it is)."""
    first = trees[0]
    if dataclasses.is_dataclass(first):
        return type(first)(**{f.name: tree_map(fn, *(getattr(t, f.name) for t in trees))
                              for f in dataclasses.fields(first)})
    if isinstance(first, tuple):
        return tuple(tree_map(fn, *leaves) for leaves in zip(*trees))
    return None if first is None else fn(*trees)


def tree_leaves(tree) -> list:
    """The tensors of a parameter tree in field order (``None`` skipped) —
    ``jax.tree.leaves``' order for the same dataclass."""
    if dataclasses.is_dataclass(tree):
        return [leaf for f in dataclasses.fields(tree) for leaf in tree_leaves(getattr(tree, f.name))]
    if isinstance(tree, tuple):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [] if tree is None else [tree]


def pad_rows(x: torch.Tensor, total: int) -> torch.Tensor:
    """Zero-pad axis 0 of ``x`` up to ``total`` rows."""
    if x.shape[0] == total:
        return x
    return torch.cat([x, x.new_zeros((total - x.shape[0],) + tuple(x.shape[1:]))])


def clip_by_global_norm(tree, max_norm: float):
    """Scale a gradient tree so its global L2 norm is at most ``max_norm``
    (flag-gated stability extension; off by default)."""
    gnorm = torch.sqrt(sum(torch.sum(torch.square(leaf)) for leaf in tree_leaves(tree)))
    scale = torch.clamp(torch.full_like(gnorm, max_norm) / gnorm.clamp_min(1e-12), max=1.0)
    return tree_map(lambda leaf: leaf * scale, tree)


class QBMModel(abc.ABC):
    """Protocol every model family satisfies."""

    @abc.abstractmethod
    def weight_objects(self) -> list:
        """Reference-format weight list for pickle checkpoints."""

    @abc.abstractmethod
    def train_for_one_iteration(self, x_batch, y_batch, learning_rate, mask=None):
        """One masked moment-matching update; returns (err, nll)."""

    @abc.abstractmethod
    def predict_batch(self, X):
        """(predictions, class_probs) for a batch of inputs."""

    def save_weights(self, title: str, path: str = "out"):
        save_weight_pickle(self.weight_objects(), title, path)

    def predict(self, data):
        preds, _ = self.predict_batch(np.asarray(data)[None])
        return int(preds[0])

    def get_num_params(self):
        """Total trainable parameter count."""
        return sum(int(p.numel()) for p in tree_leaves(self.params))


class EpochLaunchMixin:
    """Whole-epoch training over device-resident batches.

    The padded and masked batches of a training set are uploaded once and
    cached on the model's device; an epoch is a Python loop of
    ``_step(x, y, mask, lr)`` calls whose per-step nll/err stay device
    tensors and are fetched once at the end of the epoch.

    Requirements on the host class: ``device`` and ``_step``.
    """

    def _prepare_inputs(self, x: np.ndarray) -> np.ndarray:
        """Hook: host inputs in the layout ``_step`` takes (identity here;
        the CDQBM reshapes flat rows to images)."""
        return x

    # Caches are keyed by WEAK references to the host objects: id() alone can
    # be recycled by a new same-length array after the old one is freed.

    def _cache_lookup(self, attr: str, objs: tuple, extra):
        entry = getattr(self, attr, None)
        if entry is None:
            return None
        refs, stored_extra, value = entry
        if stored_extra != extra or len(refs) != len(objs):
            return None
        if any(ref() is not obj for ref, obj in zip(refs, objs)):
            return None
        return value

    def _cache_store(self, attr: str, objs: tuple, extra, value):
        try:
            refs = tuple(weakref.ref(o) for o in objs)
        except TypeError:
            return  # unreferenceable host object: skip caching
        setattr(self, attr, (refs, extra, value))

    def _cached_device_input(self, X) -> torch.Tensor:
        """Device copy of a repeatedly used input set (e.g. the per-epoch
        validation inputs), cached by identity of the host object."""
        x = self._cache_lookup("_predict_data", (X,), None)
        if x is None:
            x = self._prepare_inputs(np.asarray(X, dtype="float32"))
            with span("sync.upload_val"):
                x = torch.as_tensor(x, device=self.device)
            self._cache_store("_predict_data", (X,), None, x)
        return x

    def train_epoch(self, x, y, batch_size, learning_rate, progress: bool = False):
        """One epoch; the ragged tail batch is zero-padded and masked.
        Returns per-batch (nll, err) numpy arrays.  Callers must not mutate
        ``x``/``y`` in place between epochs (the device copy is cached by
        array identity).  ``progress``: a tqdm bar over the batches."""
        from qbmx_torch.train.loop import _pad_batch, progress_bar

        cached = self._cache_lookup("_epoch_data", (x, y), batch_size)
        if cached is None:
            xh = self._prepare_inputs(np.asarray(x, dtype="float32"))
            nb = -(-len(xh) // batch_size)
            xp, yp, mask = _pad_batch(xh, np.asarray(y), nb * batch_size)
            dev = self.device
            with span("sync.upload_x"):
                xd = torch.as_tensor(xp.reshape((nb, batch_size) + xh.shape[1:]), device=dev)
            with span("sync.upload_y"):
                yd = torch.as_tensor(yp.reshape(nb, batch_size), device=dev)
            with span("sync.upload_mask"):
                maskd = torch.as_tensor(mask.reshape(nb, batch_size), device=dev)
            cached = (xd, yd, maskd)
            self._cache_store("_epoch_data", (x, y), batch_size, cached)
        xb, yb, maskb = cached
        nlls, errs = [], []
        for i in progress_bar(range(xb.shape[0]), "epoch", progress):
            nll, err = self._step(xb[i], yb[i], maskb[i], learning_rate)
            nlls.append(nll)
            errs.append(err)
        with span("sync.epoch_nll"):
            nlls = torch.stack(nlls).cpu().numpy()
        with span("sync.epoch_err"):
            errs = torch.stack(errs).cpu().numpy()
        return nlls, errs
