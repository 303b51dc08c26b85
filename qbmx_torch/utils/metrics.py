"""Metrics and run-result reporting in numpy (counterpart of
``qbmx.utils.metrics``, without scikit-learn).

``get_metrics`` follows the reference ``src/metrics.py:190-202``: accuracy
plus binary (two classes) or macro f1/precision/recall with
``zero_division=0``, and an AUC scored on the HARD predictions (0.0 when
``y_true`` holds a single class, and for multiclass runs).  The AUC is the
Mann-Whitney statistic with average ranks for ties, which is what
scikit-learn's ``roc_auc_score`` computes.  The pickle names are
``qbmx``'s.
"""

from __future__ import annotations

import dataclasses
import pickle
from pathlib import Path

import numpy as np


@dataclasses.dataclass
class History:
    """Reference ``metrics.History`` fields plus ``prob_auc_per_epoch``
    (AUC scored on class probabilities, :func:`prob_scored_auc`)."""

    errors_per_batch: list = dataclasses.field(default_factory=list)
    error_per_epoch: list = dataclasses.field(default_factory=list)
    nll_per_batch: list = dataclasses.field(default_factory=list)
    nll_per_epoch: list = dataclasses.field(default_factory=list)
    acc_per_epoch: list = dataclasses.field(default_factory=list)
    auc_per_epoch: list = dataclasses.field(default_factory=list)
    combined_acc_auc_per_epoch: list = dataclasses.field(default_factory=list)
    distribution_per_epoch: list = dataclasses.field(default_factory=list)
    prob_auc_per_epoch: list = dataclasses.field(default_factory=list)


def _prf(tp, fp, fn):
    """(precision, recall, f1) with 0 wherever a denominator is 0."""
    div = lambda a, b: a / b if b else 0.0
    return div(tp, tp + fp), div(tp, tp + fn), div(2 * tp, 2 * tp + fp + fn)


def _counts(y_true, y_pred, label):
    t, p = y_true == label, y_pred == label
    return int(np.sum(t & p)), int(np.sum(~t & p)), int(np.sum(t & ~p))


def binary_auc(y_true, scores) -> float:
    """ROC-AUC of ``scores`` for the larger of exactly two labels in
    ``y_true``; raises ``ValueError`` unless ``y_true`` holds two classes."""
    y_true = np.asarray(y_true).ravel()
    scores = np.asarray(scores, dtype=np.float64).ravel()
    classes = np.unique(y_true)
    if len(classes) != 2:
        raise ValueError(f"AUC needs exactly two classes in y_true, got {len(classes)}")
    pos = y_true == classes[1]
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty(len(scores), dtype=np.float64)
    sorted_scores = scores[order]
    # average 1-based ranks over runs of tied scores
    starts = np.flatnonzero(np.r_[True, np.diff(sorted_scores) != 0])
    ends = np.r_[starts[1:], len(scores)]
    for a, b in zip(starts, ends):
        ranks[order[a:b]] = 0.5 * (a + 1 + b)
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def get_metrics(y_true, y_predict, class_titles):
    """(acc, f1, precision, recall, auc); binary vs macro by the number of
    classes (``src/metrics.py:190-202``)."""
    y_true = np.asarray(y_true).ravel()
    y_predict = np.asarray(y_predict).ravel()
    acc = float(np.mean(y_true == y_predict))
    if len(class_titles) == 2:
        precision, recall, f1 = _prf(*_counts(y_true, y_predict, 1))
        auc = _safe_auc(y_true, y_predict)
    else:
        per = [_prf(*_counts(y_true, y_predict, c))
               for c in np.union1d(y_true, y_predict)]
        precision, recall, f1 = (float(np.mean(v)) for v in zip(*per))
        auc = 0.0
    return acc, f1, precision, recall, auc


def accuracy_and_auc(y_true, y_pred):
    """(accuracy, AUC scored on the hard predictions): the reference RBM's
    evaluation pair (``src/ClassificationRBM.py:251-294``)."""
    y_true = np.asarray(y_true).ravel()
    y_pred = np.asarray(y_pred).ravel()
    return float(np.mean(y_true == y_pred)), _safe_auc(y_true, y_pred)


def _safe_auc(y_true, scores):
    try:
        return binary_auc(y_true, scores)
    except ValueError:  # single-class (or multiclass) y_true
        return 0.0


def prob_scored_auc(y_true, probs):
    """ROC-AUC from class probabilities ``probs`` (B, C): column 1 for two
    classes, macro one-vs-rest otherwise; 0.0 when ``y_true`` lacks a class."""
    y_true = np.asarray(y_true).ravel()
    p = np.asarray(probs, dtype=np.float64)
    try:
        if p.shape[1] == 2:
            out = binary_auc(y_true, p[:, 1])
        else:
            classes = np.unique(y_true)
            if len(classes) != p.shape[1]:
                raise ValueError("y_true does not hold every class")
            p = p / np.clip(p.sum(axis=1, keepdims=True), 1e-12, None)
            out = float(np.mean([binary_auc(y_true == c, p[:, k])
                                 for k, c in enumerate(classes)]))
        return float(out) if np.isfinite(out) else 0.0
    except ValueError:
        return 0.0


def get_result_as_txt(
    acc, f1, precision, recall, auc_score, num_classes, input_dim, n_output_nodes,
    n_hidden_nodes, batch_size, epochs, optimizer, learning_rate,
    qpu_time_used="-", beta_eff="-",
):
    """Reference result text format (``src/metrics.py:171-188``)."""
    return (
        f"Accuracy: {acc}\n"
        f"AUC ROC score: {auc_score}\n"
        f"F1 Score: {f1}\n"
        f"Precision: {precision}\n"
        f"Recall: {recall}\n"
        f"Classes: {num_classes}\n"
        f"Input Dimension: {input_dim}\n"
        f"Number of Output Nodes: {n_output_nodes}\n"
        f"Number of Hidden Nodes: {n_hidden_nodes}\n"
        f"Batch Size: {batch_size}\n"
        f"Epochs: {epochs}\n"
        f"Optimizer: {optimizer}\n"
        f"Learning Rate: {learning_rate}\n"
        f"QPU Time Used: {qpu_time_used}\n"
        f"Beta Eff: {beta_eff}\n"
    )


def save_result(file_path: str, model, history: History, trained_params, y_true,
                y_predict, class_titles, batch_size, epochs, optimizer, learning_rate,
                qpu_time_used="-", save=True, make_plots=False):
    """Weights pickle + ``*_result.txt`` + ``*acc_auc.pkl`` + history
    pickles, and with ``make_plots`` the five figures of
    ``plots.save_all`` (reference ``save_result``,
    ``src/metrics.py:205-236``)."""
    acc, f1, precision, recall, auc = get_metrics(y_true, y_predict, class_titles)
    result_txt = get_result_as_txt(
        acc, f1, precision, recall, auc,
        class_titles,
        getattr(model, "dim_input", "-"),
        getattr(model, "n_output_nodes", "-"),
        getattr(model, "n_hidden_nodes", "-"),
        batch_size, epochs, optimizer, learning_rate,
        qpu_time_used=qpu_time_used,
        beta_eff=getattr(model, "beta_eff", "-"),
    )
    file_path = str(file_path)
    if save:
        Path(file_path).parent.mkdir(parents=True, exist_ok=True)
        with open(file_path + ".pkl", "wb") as f:
            pickle.dump(trained_params, f)
        with open(file_path + "_result.txt", "w") as f:
            f.write(result_txt)
        save_history(file_path, history)
        with open(file_path + "acc_auc.pkl", "wb") as f:
            pickle.dump((acc, auc), f)
    if make_plots:
        from qbmx_torch.utils import plots

        Path(file_path).parent.mkdir(parents=True, exist_ok=True)
        plots.save_all(file_path, history, y_true, y_predict, class_titles)
    return acc, f1, precision, recall, auc


_HISTORY_FILES = {
    "loss_per_batch.pkl": "errors_per_batch",
    "loss_per_epoch.pkl": "error_per_epoch",
    "nll_per_batch.pkl": "nll_per_batch",
    "nll_per_epoch.pkl": "nll_per_epoch",
    "acc_per_epoch.pkl": "acc_per_epoch",
    "auc_per_epoch.pkl": "auc_per_epoch",
    "combined_acc_auc_per_epoch.pkl": "combined_acc_auc_per_epoch",
}


def save_history(file_path_and_name: str, history: History):
    """Reference per-series history pickles (``src/metrics.py:239-259``)."""
    for name, field in _HISTORY_FILES.items():
        with open(file_path_and_name + name, "wb") as f:
            pickle.dump(getattr(history, field), f)


def load_history(file_path_and_name: str) -> History:
    """Every series :func:`save_history` writes (``qbmx``'s too), read
    back; a missing file reads as ``[]``."""
    loaded = {}
    for name, field in _HISTORY_FILES.items():
        path = Path(file_path_and_name + name)
        if path.exists():
            with open(path, "rb") as f:
                loaded[field] = pickle.load(f)
    return History(**loaded)

