"""Epoch training loop (counterpart of ``qbmx.train.loop``).

Per epoch: one whole-epoch launch (``model.train_epoch``: device-cached
padded batches, per-step losses fetched once), a weight pickle, and
validation accuracy/AUC (+ their 50/50 combination); every N epochs a
full-state checkpoint (``utils/checkpoint.py``).  On any failure the
weights and history are saved as crash pickles, the full state as a
``mid_epoch`` crash checkpoint, and the error re-raised (reference
``src/model/faster_dqbm.py:1128-1132``).  A model sharded over a mesh
(``parallel.mesh.shard_model``) trains here unchanged; only its global
rank 0 writes files.
"""

from __future__ import annotations

import itertools
import pickle
from pathlib import Path

import numpy as np

from qbmx_torch.parallel.mesh import writes_files
from qbmx_torch.utils.checkpoint import save_checkpoint
from qbmx_torch.utils.metrics import History, get_metrics, prob_scored_auc, save_history
from qbmx_torch.utils.spans import span, spanned

#: examples sampled per epoch for ``track_distribution``
_DISTRIBUTION_SAMPLE_EXAMPLES = 64


def progress_bar(iterable, desc: str, enabled: bool):
    """A tqdm bar over ``iterable`` when ``enabled`` (the reference wraps its
    batch loops in tqdm, e.g. ``src/train/train.py:268``); inert when
    tqdm cannot be imported, as in ``qbmx``."""
    if not enabled:
        return iterable
    try:
        from tqdm import tqdm
    except ImportError:
        return iterable
    return tqdm(iterable, desc=desc, leave=False)


def _pad_batch(x, y, batch_size):
    n = x.shape[0]
    if n == batch_size:
        return x, y, np.ones(n, dtype="float32")
    pad = batch_size - n
    xp = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
    yp = np.concatenate([y, np.zeros((pad,) + y.shape[1:], y.dtype)])
    mask = np.concatenate([np.ones(n, "float32"), np.zeros(pad, "float32")])
    return xp, yp, mask


def output_patterns(model):
    """All output-node bit patterns as ``get_result_distribution`` keys."""
    O = int(getattr(model, "n_output_nodes", 1))
    if getattr(model, "use_one_hot_encoding", False) and O > 1:
        return ["".join(bits) for bits in itertools.product("01", repeat=O)]
    return ["0", "1"]


def majority_fraction(val_Y) -> float:
    """The share of the most frequent class in ``val_Y``: the accuracy of
    always predicting it."""
    vy = np.asarray(val_Y)
    return max(float(np.mean(vy == c)) for c in np.unique(vy))


def flatlined(acc_per_epoch, val_Y, window: int) -> bool:
    """The collapse rule of flatline recovery: the validation accuracy
    stayed at or below the majority-class fraction over the last
    ``window`` epochs (only those, so a recovered model is never re-drawn).
    The single-model loop and the seed sweep (``train/sweep.py``) both ask
    it."""
    return max(acc_per_epoch[-window:]) <= majority_fraction(val_Y) + 1e-9


def _maybe_reinit(model, history, val_Y, window: int, verbose: bool) -> None:
    """Flatline recovery: re-draw the model if it :func:`flatlined`.  The
    attempt counter lives on the model, so every re-draw takes a fresh
    stream."""
    if not flatlined(history.acc_per_epoch, val_Y, window):
        return
    maj = majority_fraction(val_Y)
    model._reinit_attempt = int(getattr(model, "_reinit_attempt", 0)) + 1
    model.reinit_params(attempt=model._reinit_attempt)
    if verbose:
        print(f"re-initialized flatlined model (val_acc <= majority fraction "
              f"{maj:.3f} over the last {window} epochs)")


@spanned("train")
def train_model(
    model,
    train_X,
    train_Y,
    val_X=None,
    val_Y=None,
    batch_size: int = 8,
    learning_rate: float = 0.005,
    epochs: int | None = None,
    save_folder: str | None = None,
    class_titles=("0", "1"),
    verbose: bool = True,
    history: History | None = None,
    reinit_on_collapse: int = 0,
    checkpoint_every: int = 0,
    checkpoint_path: str | None = None,
    start_epoch: int = 0,
    track_distribution: bool = False,
    progress: bool = False,
) -> History:
    """Train ``model`` through epoch ``epochs``; returns the ``History``.

    ``reinit_on_collapse`` (0 = off, needs ``val_X``): every N epochs,
    re-draw a model whose validation accuracy stayed at the majority-class
    fraction (never after the final epoch).  ``track_distribution``: per
    epoch, append the unclamped output-pattern distribution on (a bounded
    slice of) the validation inputs to ``history.distribution_per_epoch``.

    ``checkpoint_every``: every N epochs write the full state (parameters,
    random stream, history, epoch) to ``checkpoint_path``; resuming from it
    (``utils.checkpoint.load_checkpoint``, then ``start_epoch`` = its epoch
    and ``history`` = its history) reproduces the uninterrupted run bit for
    bit.  Epochs run from ``start_epoch + 1`` to ``epochs``.  On a crash
    the state goes to ``<checkpoint_path>_crash``, stamped ``mid_epoch``:
    an epoch is a loop of steps, so its parameters may be part-way through
    one, and ``load_checkpoint`` refuses it without ``allow_mid_epoch``.

    ``progress``: a tqdm bar over each epoch's batch loop
    (``model.train_epoch(..., progress=True)``).
    """
    train_X = np.asarray(train_X, dtype="float32")
    train_Y = np.asarray(train_Y)
    epochs = epochs if epochs is not None else getattr(model, "epochs", 1)
    history = history if history is not None else (
        getattr(model, "training_history", None) or History())
    model.training_history = history
    if not writes_files(model):
        save_folder = checkpoint_path = None
    if save_folder:
        Path(save_folder).mkdir(parents=True, exist_ok=True)
    num_batches = max(-(-len(train_X) // batch_size), 1)

    for epoch in range(start_epoch + 1, epochs + 1):
        with span("epoch"):
            try:
                # asked only when set: a model without a bar keeps its signature
                nlls, errs = model.train_epoch(train_X, train_Y, batch_size, learning_rate,
                                               **({"progress": True} if progress else {}))
            except BaseException:  # incl. KeyboardInterrupt: save, then re-raise
                if save_folder:
                    model.save_weights(f"e{epoch}_crash", save_folder)
                    save_history(f"{save_folder}/", history)
                if checkpoint_path:
                    save_checkpoint(f"{checkpoint_path}_crash", model, history, epoch - 1,
                                    mid_epoch=True)
                raise
            history.errors_per_batch.extend(float(e) for e in errs)
            history.nll_per_batch.extend(float(v) for v in nlls)
            epoch_errors, epoch_nll = float(np.sum(errs)), float(np.sum(nlls))
            if save_folder:
                model.save_weights(f"e{epoch}", save_folder)

            if val_X is not None:
                with span("validate"):
                    preds, probs = model.predict_batch(np.asarray(val_X, dtype="float32"))
                    acc, _, _, _, auc = get_metrics(val_Y, preds, list(class_titles))
                    history.acc_per_epoch.append(acc)
                    history.auc_per_epoch.append(auc)
                    history.combined_acc_auc_per_epoch.append(0.5 * acc + 0.5 * auc)
                    history.prob_auc_per_epoch.append(prob_scored_auc(val_Y, probs))
                if verbose:
                    print(f"Epoch {epoch}/{epochs}  nll={epoch_nll / num_batches:.4f}  "
                          f"val_acc={acc:.4f}  val_auc={auc:.4f}")
                if (reinit_on_collapse and epoch % reinit_on_collapse == 0
                        and epoch < epochs and hasattr(model, "reinit_params")):
                    _maybe_reinit(model, history, val_Y, reinit_on_collapse, verbose)
            elif verbose:
                print(f"Epoch {epoch}/{epochs}  nll={epoch_nll / num_batches:.4f}")

            if track_distribution and hasattr(model, "sample_output_patterns"):
                src = val_X if val_X is not None else train_X
                pats = model.sample_output_patterns(
                    np.asarray(src[:_DISTRIBUTION_SAMPLE_EXAMPLES], dtype="float32"))
                history.distribution_per_epoch.append(
                    model.get_result_distribution(pats, output_patterns(model)))

            history.error_per_epoch.append(epoch_errors / num_batches)
            history.nll_per_epoch.append(epoch_nll / num_batches)
            if checkpoint_every and checkpoint_path and epoch % checkpoint_every == 0:
                save_checkpoint(checkpoint_path, model, history, epoch)

    if save_folder:
        seed = getattr(model, "seed", 0)
        for name, series in (
            (f"acc_per_epoch{seed}.pkl", history.acc_per_epoch),
            (f"auc_per_epoch{seed}.pkl", history.auc_per_epoch),
            (f"combined_acc_auc_per_epoch{seed}.pkl", history.combined_acc_auc_per_epoch),
        ):
            with open(Path(save_folder) / name, "wb") as f:
                pickle.dump(series, f)
    return history


def get_best_combined_acc_auc(history: History):
    """(best epoch, acc, auc, combined) at the best 0.5·acc + 0.5·auc epoch."""
    best_epoch = int(np.argmax(history.combined_acc_auc_per_epoch))
    return (
        best_epoch,
        history.acc_per_epoch[best_epoch],
        history.auc_per_epoch[best_epoch],
        history.combined_acc_auc_per_epoch[best_epoch],
    )
