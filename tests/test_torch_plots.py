"""qbmx_torch.utils.plots and utils.viz against qbmx.utils.plots and
qbmx.utils.viz: each figure draws the same data (line data, bar heights and
bottoms, box data, the confusion-matrix image and its cell text, the
architecture's boxes and labels), ``save_all`` writes ``qbmx``'s file
names, and ``qbm_main --track_distribution --save`` writes the
distribution figure.  The port counts the confusion matrix in numpy; it is
held to scikit-learn's."""

from __future__ import annotations

import pickle
import sys

import matplotlib
import matplotlib.pyplot as plt
import numpy as np
import pytest
from sklearn.metrics import confusion_matrix as sk_confusion_matrix

import qbmx.utils.plots as jp
import qbmx_torch.utils.plots as tp
from qbmx.utils.metrics import History as JHistory
from qbmx_torch.utils.metrics import History as THistory


@pytest.fixture(autouse=True)
def close_figures():
    yield
    plt.close("all")


def lines(fig):
    return [(ln.get_xydata().tolist(), ln.get_color()) for ax in fig.axes for ln in ax.get_lines()]


def labels(fig):
    return [(ax.get_title(), ax.get_xlabel(), ax.get_ylabel(),
             [t.get_text() for t in ax.get_xticklabels()]) for ax in fig.axes]


@pytest.mark.parametrize("name", ["get_loss_func_per_batch", "get_loss_func_per_epoch",
                                  "get_nll_func_per_batch", "get_nll_func_per_epoch"])
@pytest.mark.parametrize("series", [[0.7, 0.6, 0.65, 0.5], [0.3], []])
def test_series_figures_draw_qbmx_s_lines(name, series):
    ours, theirs = getattr(tp, name)(series), getattr(jp, name)(series)
    assert lines(ours) == lines(theirs) and labels(ours) == labels(theirs)


CM_CASES = [([0, 1, 1, 0], [0, 1, 0, 0]), ([1, 1, 1], [1, 1, 1]),
            ([2, 0, 1, 2, 2, 0], [2, 1, 1, 0, 2, 0]), ([0, 0, 1], [1, 1, 1])]


@pytest.mark.parametrize("y,y_pred", CM_CASES)
def test_confusion_matrix_counts_as_scikit_learn(y, y_pred):
    cm, classes = tp.confusion_matrix(y, y_pred)
    np.testing.assert_array_equal(classes, np.unique(np.concatenate((y, y_pred))))
    np.testing.assert_array_equal(cm, sk_confusion_matrix(y, y_pred, labels=classes))


@pytest.mark.parametrize("y,y_pred", CM_CASES)
@pytest.mark.parametrize("titles", [None, "names"])
def test_confusion_figure_draws_qbmx_s_matrix(y, y_pred, titles):
    k = len(np.unique(np.concatenate((y, y_pred))))
    titles = None if titles is None else [f"c{i}" for i in range(k)]
    ours, theirs = tp.get_confusion_matrix(y, y_pred, titles), jp.get_confusion_matrix(
        y, y_pred, titles)
    np.testing.assert_array_equal(ours.axes[0].images[0].get_array(),
                                  theirs.axes[0].images[0].get_array())
    texts = lambda f: [(t.get_text(), t.get_position()) for t in f.axes[0].texts]  # noqa: E731
    assert texts(ours) == texts(theirs)
    assert labels(ours)[0] == labels(theirs)[0]
    assert [t.get_text() for t in ours.axes[0].get_yticklabels()] == \
        [t.get_text() for t in theirs.axes[0].get_yticklabels()]


@pytest.mark.parametrize("probs,legend", [
    ([[0.25, 0.75], [0.6, 0.4], [0.5, 0.5]], ["0", "1"]),
    ([[0.1, 0.2, 0.3, 0.4], [0.4, 0.3, 0.2, 0.1]], ["00", "01", "10"]),  # a label short
])
def test_distribution_figure_draws_qbmx_s_bars(tmp_path, probs, legend):
    ticks = [f"e{i + 1}" for i in range(len(probs))]
    ours = tp.show_and_save_distribution(probs, ticks, str(tmp_path / "t.png"), "T", legend,
                                         save=True)
    theirs = jp.show_and_save_distribution(probs, ticks, str(tmp_path / "j.png"), "T", legend,
                                           save=True)
    bars = lambda f: [(p.get_x(), p.get_y(), p.get_height(), p.get_facecolor())  # noqa: E731
                      for p in f.axes[0].patches]
    assert bars(ours) == bars(theirs) and labels(ours) == labels(theirs)
    assert [t.get_text() for t in ours.axes[0].get_legend().get_texts()] == \
        [t.get_text() for t in theirs.axes[0].get_legend().get_texts()]
    assert (tmp_path / "t.png").stat().st_size > 0 and (tmp_path / "j.png").exists()


def test_save_all_writes_qbmx_s_files(tmp_path):
    kw = dict(errors_per_batch=[0.1, 0.2], error_per_epoch=[0.15], nll_per_batch=[0.7, 0.6],
              nll_per_epoch=[0.65])
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    tp.save_all(str(tmp_path / "t" / "run"), THistory(**kw), [0, 1, 1, 0], [0, 1, 0, 0],
                ["0", "1"])
    jp.save_all(str(tmp_path / "j" / "run"), JHistory(**kw), [0, 1, 1, 0], [0, 1, 0, 0],
                ["0", "1"])
    ours = sorted(p.name for p in (tmp_path / "t").iterdir())
    assert ours == sorted(p.name for p in (tmp_path / "j").iterdir())
    assert ours == sorted("run" + s for s in tp.FIGURE_FILES)
    assert plt.get_fignums() == []  # every figure closed


def test_make_plots_holds_the_five_figures():
    h = THistory(errors_per_batch=[0.1, 0.2], error_per_epoch=[0.15], nll_per_batch=[0.7, 0.6],
                 nll_per_epoch=[0.65])
    p = tp.make_plots(h, [0, 1], [1, 1])
    assert all(isinstance(getattr(p, f), matplotlib.figure.Figure)
               for f in tp.FIGURE_FILES.values())
    assert lines(p.nll_per_batch_fig) == lines(jp.get_nll_func_per_batch([0.7, 0.6]))


def test_save_result_with_plots(tmp_path):
    from qbmx_torch.models.dqbm import DiscQBM
    from qbmx_torch.utils.metrics import save_result

    m = DiscQBM(dim_input=3, n_hidden_nodes=2, seed=0, sample_count=8, device="cpu")
    h = THistory(errors_per_batch=[0.1], error_per_epoch=[0.1], nll_per_batch=[0.7],
                 nll_per_epoch=[0.7])
    acc, *_ = save_result(str(tmp_path / "r"), m, h, m.weight_objects(), [0, 1], [0, 1],
                          ["0", "1"], 2, 1, "SA", 0.1, make_plots=True)
    assert acc == 1.0
    assert (tmp_path / "r_result.txt").exists() and (tmp_path / "r_confusion_matrix.png").exists()
    save_result(str(tmp_path / "q"), m, h, m.weight_objects(), [0, 1], [0, 1], ["0", "1"], 2, 1,
                "SA", 0.1)
    assert not (tmp_path / "q_confusion_matrix.png").exists()


@pytest.mark.parametrize("groups", [{"a": [0.5, 0.7, 0.6], "b": [0.6, 0.65]}, {"x": [1.0]}])
def test_seed_boxplot_draws_qbmx_s_boxes(groups):
    ours, theirs = tp.seed_boxplot(groups), jp.seed_boxplot(groups)
    assert lines(ours) == lines(theirs) and labels(ours) == labels(theirs)


def test_seed_boxplot_from_pickles(tmp_path):
    for name, runs in (("sweepA", [(1, [0.5, 0.7]), (2, [0.6, 0.65])]),
                       ("sweepB", [(1, [0.4, 0.8]), (3, []), (4, [0.55])])):
        (tmp_path / name).mkdir()
        for seed, series in runs:
            with open(tmp_path / name / f"runacc_per_epoch{seed}.pkl", "wb") as f:
                pickle.dump(series, f)
    folders = [tmp_path / "sweepA", tmp_path / "sweepB"]
    ours, theirs = tp.seed_boxplot_from_pickles(folders), jp.seed_boxplot_from_pickles(folders)
    assert lines(ours) == lines(theirs) and labels(ours) == labels(theirs)
    for mod in (tp, jp):
        with pytest.raises(FileNotFoundError, match="per_epoch"):
            mod.seed_boxplot_from_pickles([tmp_path / "sweepA"], metric="auc")


def test_drawing_without_matplotlib_raises_naming_it(monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        tp.get_loss_func_per_batch([0.1])


@pytest.mark.parametrize("cfg", [
    dict(image_shape=(6, 6), kernel_size=3, pooling_size=2, pooling_type="probabilistic",
         sequential_layer_sizes=[3]),
    dict(image_shape=(28, 28), kernel_size=3, pooling_size=4, pooling_type="deterministic",
         sequential_layer_sizes=[4]),
    dict(image_shape=(8, 8), kernel_size=3, n_kernels=2, pooling_size=1,
         sequential_layer_sizes=[3, 2], num_label_nodes=2),
])
def test_visualize_architecture_draws_a_layer_for_each_of_geo_s(tmp_path, cfg):
    from qbmx.models.cdqbm import CDQBM as JCDQBM
    from qbmx.utils.viz import visualize_architecture as j_viz
    from qbmx_torch.models.cdqbm import CDQBM
    from qbmx_torch.utils.viz import architecture_layers, visualize_architecture

    tm, jm = CDQBM(seed=0, device="cpu", **cfg), JCDQBM(seed=0, **cfg)
    ours = visualize_architecture(tm, save_path=str(tmp_path / "arch.png"))
    theirs = j_viz(jm)
    layers = architecture_layers(tm.geo)
    geo = tm.geo
    assert len(layers) == 3 + bool(geo.has_pooling) + len(geo.seq_sizes)
    assert [c for *_, c in layers][-1] == geo.n_out
    boxes = lambda f: [(p.get_xy(), p.get_height()) for p in f.axes[0].patches]  # noqa: E731
    assert len(boxes(ours)) == len(layers) and boxes(ours) == boxes(theirs)
    texts = lambda f: [t.get_text() for t in f.axes[0].texts]  # noqa: E731
    assert texts(ours) == texts(theirs) and ours.axes[0].get_title() == theirs.axes[0].get_title()
    assert (tmp_path / "arch.png").stat().st_size > 0


def test_qbm_main_track_distribution_writes_the_figure(tmp_path):
    from qbmx_torch.cli import qbm_main

    save = f"{tmp_path}/"
    qbm_main.main(data_set="synthetic", n_hidden_nodes=2, sample_count=8, anneal=5,
                  batch_size=200, epochs=2, save=save, name="run", device="cpu",
                  track_distribution=True)
    (png,) = tmp_path.glob("*_distribution.png")
    assert png.name.startswith("_se19_h2_solSA_sc8") and png.stat().st_size > 0
    assert plt.get_fignums() == []
