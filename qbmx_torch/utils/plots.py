"""Figures (the counterpart of ``qbmx.utils.plots``): loss and nll per
batch and per epoch, the confusion matrix, the stacked output-distribution
bars and the seed box plots.

matplotlib is imported inside the functions, with the Agg backend, so
importing the port never needs it; where it is missing, drawing raises
``ImportError`` naming it.  The confusion matrix is counted in numpy (no
scikit-learn) and drawn as scikit-learn's ``ConfusionMatrixDisplay`` draws
it.
"""

from __future__ import annotations

import dataclasses
import pickle
from pathlib import Path

import numpy as np


def pyplot():
    """``matplotlib.pyplot`` on the Agg backend."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("drawing figures needs matplotlib, which is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _series_fig(series, title, xlabel, ylabel, color):
    plt = pyplot()
    fig, ax = plt.subplots()
    ax.set_title(title)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    n = len(series)
    ax.plot(np.linspace(1, n, n), series[:n], color=color)
    return fig


def _shown(fig, show_plot):
    if show_plot:
        pyplot().show()
    return fig


def get_loss_func_per_batch(history_per_batch, show_plot=False):
    return _shown(_series_fig(history_per_batch, "Average output node bias error per batch",
                              "Batch", "Average output node bias error", "orange"), show_plot)


def get_loss_func_per_epoch(history_per_epoch, show_plot=False):
    return _shown(_series_fig(history_per_epoch, "Average output node bias error per epoch",
                              "Epoch", "Average output node bias error", "purple"), show_plot)


def get_nll_func_per_batch(history_per_batch, show_plot=False):
    return _shown(_series_fig(history_per_batch, "Negative Log Likelihood per batch",
                              "Batch", "Negative Log Likelihood", "orange"), show_plot)


def get_nll_func_per_epoch(history_per_epoch, show_plot=False):
    return _shown(_series_fig(history_per_epoch, "Negative Log Likelihood per epoch",
                              "Epoch", "Negative Log Likelihood", "purple"), show_plot)


def confusion_matrix(y, y_predict) -> tuple[np.ndarray, np.ndarray]:
    """``(cm, classes)``: ``classes`` every label in either array, sorted;
    ``cm[i, j]`` the count of true ``classes[i]`` predicted ``classes[j]``
    (scikit-learn's ``confusion_matrix(y, y_predict, labels=classes)``)."""
    y, y_predict = np.asarray(y).ravel(), np.asarray(y_predict).ravel()
    classes = np.unique(np.concatenate((y, y_predict)))
    k = len(classes)
    cm = np.zeros((k, k), dtype=np.int64)
    np.add.at(cm, (np.searchsorted(classes, y), np.searchsorted(classes, y_predict)), 1)
    return cm, classes


def get_confusion_matrix(y, y_predict, class_titles=None, show_plot=False):
    plt = pyplot()
    cm, classes = confusion_matrix(y, y_predict)
    labels = classes if class_titles is None else class_titles
    fig, ax = plt.subplots()
    im = ax.imshow(cm, interpolation="nearest", cmap=plt.cm.Blues)
    # cell text in the colour scikit-learn's display picks: light on dark cells
    cmap_min, cmap_max = im.cmap(0), im.cmap(1.0)
    thresh = (cm.max() + cm.min()) / 2.0
    for i in range(cm.shape[0]):
        for j in range(cm.shape[1]):
            ax.text(j, i, format(cm[i, j], "d"), ha="center", va="center",
                    color=cmap_max if cm[i, j] < thresh else cmap_min)
    fig.colorbar(im, ax=ax)
    ax.set(xticks=np.arange(len(classes)), yticks=np.arange(len(classes)),
           xticklabels=labels, yticklabels=labels, ylabel="True label",
           xlabel="Predicted label")
    ax.set_ylim((len(classes) - 0.5, -0.5))
    ax.set_title("Confusion Matrix for QBM Classifier")
    return _shown(fig, show_plot)


def show_and_save_distribution(sorted_probs, x_ticks, file_path, title, legend_labels,
                               save=False):
    """Stacked probability bars over output-unit states, one bar per
    acquisition (reference ``show_and_save_distribution``,
    ``src/metrics.py:131-167``)."""
    plt = pyplot()
    num_probs = len(sorted_probs)
    num_categories = len(sorted_probs[0])
    x_positions = np.arange(num_probs)
    stacked = np.asarray(sorted_probs).T
    colors = ["blue", "orange", "pink", "green"]
    bottom = np.zeros(num_probs)
    fig = plt.figure(figsize=(8, 6))
    for i in range(num_categories):
        plt.bar(
            x_positions, stacked[i], width=0.6,
            label=legend_labels[i] if i < len(legend_labels) else f"Category {i + 1}",
            bottom=bottom, color=colors[i % len(colors)],
        )
        bottom += stacked[i]
    plt.xticks(x_positions, x_ticks, rotation=45, ha="right")
    plt.xlabel("Time of Acquiring Distribution")
    plt.ylabel("Probability")
    plt.title(title)
    plt.ylim(0, 1.1)
    plt.legend(title="Output Units States", bbox_to_anchor=(1.05, 1), loc="upper left")
    plt.tight_layout()
    if file_path and save:
        plt.savefig(file_path, bbox_inches="tight")
    return fig


@dataclasses.dataclass
class Plots:
    """The five standard figures (reference ``Plots``,
    ``src/metrics.py:24-32``), built by :func:`make_plots`."""

    conf_matrix_fig: object
    loss_per_batch_fig: object
    loss_per_epoch_fig: object
    nll_per_batch_fig: object
    nll_per_epoch_fig: object


def make_plots(history, y_true, y_predict, class_titles=None) -> Plots:
    return Plots(
        conf_matrix_fig=get_confusion_matrix(y_true, y_predict, class_titles),
        loss_per_batch_fig=get_loss_func_per_batch(history.errors_per_batch),
        loss_per_epoch_fig=get_loss_func_per_epoch(history.error_per_epoch),
        nll_per_batch_fig=get_nll_func_per_batch(history.nll_per_batch),
        nll_per_epoch_fig=get_nll_func_per_epoch(history.nll_per_epoch),
    )


#: file suffix of each figure :func:`save_all` writes (``qbmx``'s names)
FIGURE_FILES = {
    "_loss_per_iteration.png": "loss_per_batch_fig",
    "_loss_per_epoch.png": "loss_per_epoch_fig",
    "_nll_per_iteration.png": "nll_per_batch_fig",
    "_nll_per_epoch.png": "nll_per_epoch_fig",
    "_confusion_matrix.png": "conf_matrix_fig",
}


def save_all(file_path, history, y_true, y_predict, class_titles):
    """Write the five figures next to a result file (reference
    ``save_result``, ``src/metrics.py:225-231``)."""
    plt = pyplot()
    plots = make_plots(history, y_true, y_predict, class_titles)
    for suffix, field in FIGURE_FILES.items():
        fig = getattr(plots, field)
        fig.savefig(str(file_path) + suffix)
        plt.close(fig)


def seed_boxplot(groups: dict, title="best-epoch metric per seed", ylabel="metric",
                 show_plot=False):
    """One box per experiment group of per-seed best-epoch metrics:
    ``groups`` is ``{label: [per-seed best values]}``."""
    plt = pyplot()
    fig, ax = plt.subplots()
    labels = list(groups)
    ax.boxplot([np.asarray(groups[k], dtype=float) for k in labels], tick_labels=labels)
    ax.set_title(title)
    ax.set_ylabel(ylabel)
    ax.grid(True, axis="y", alpha=0.3)
    return _shown(fig, show_plot)


def seed_boxplot_from_pickles(folders, metric="acc", **kwargs):
    """:func:`seed_boxplot` over sweep output folders: each folder one box,
    each of its ``*{metric}_per_epoch*.pkl`` series reduced to its best
    epoch."""
    groups = {}
    for folder in folders:
        p = Path(folder)
        vals = []
        for f in sorted(p.glob(f"*{metric}_per_epoch*.pkl")):
            with open(f, "rb") as fh:
                series = pickle.load(fh)
            if series:
                vals.append(max(series))
        if not vals:
            raise FileNotFoundError(f"no *{metric}_per_epoch*.pkl with data under {p}")
        groups[p.name] = vals
    return seed_boxplot(groups, ylabel=f"best-epoch {metric}", **kwargs)
