"""qbmx_torch.utils.checkpoint and the loop's and CLIs' resume path, against
qbmx.utils.checkpoint and qbmx's own loop tests (``tests/test_train_loop.py``).

A run resumed from a ``checkpoint_every`` state equals the uninterrupted
run bit for bit on the plain route: parameters, history and the model's
``torch.Generator`` state, for the flat Disc_QBM, the CDQBM and the RBM
(``ClassificationRBM.train_rbm``, f32 and bf16, and ``rbm_main --resume``).  The
``param:`` key names are ``qbmx``'s; parameters, history and epoch cross
between the packages both ways, the random stream in neither (a jax key
and a torch Generator state have no common form).  The refusals and the
crash snapshot follow ``qbmx``: another model class, a ``mid_epoch``
snapshot without the opt-in, a missing key, a shape mismatch.  The CLI
guards raise as ``qbmx``'s do.
"""

from __future__ import annotations

import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qbmx.models.cdqbm as jc
import qbmx.models.dqbm as jd
import qbmx.models.rbm as jr
import qbmx.train.loop as jloop
import qbmx.utils.checkpoint as jck
import qbmx_torch.models.cdqbm as tc
import qbmx_torch.models.dqbm as td
import qbmx_torch.models.rbm as tr
import qbmx_torch.train.loop as tloop
import qbmx_torch.utils.checkpoint as tck
from qbmx.cli import cdqbm_main as jcmain
from qbmx.cli import qbm_main as jmain
from qbmx_torch.cli import cdqbm_main as tcmain
from qbmx_torch.cli import qbm_main as tmain
from qbmx_torch.cli import rbm_main as trmain
from qbmx_torch.samplers.api import get_sampler

torch.set_num_threads(1)
CDQBM_KW = dict(image_shape=(6, 6), kernel_size=3, stride=3, sequential_layer_sizes=[2], seed=5,
                sample_count=16, learn_penalty=True, pooling_size=2,
                pooling_type="probabilistic")


def _dqbm(**kw):
    return td.DiscQBM(dim_input=6, n_hidden_nodes=3, seed=7, sample_count=32, restricted=False,
                      sampler=get_sampler("BMS", num_sweeps=4), device="cpu", **kw)


def _cdqbm(pooling_type="probabilistic"):
    kw = {**CDQBM_KW, "pooling_type": pooling_type,
          "learn_penalty": pooling_type == "probabilistic"}
    return tc.CDQBM(sampler=get_sampler("BMS", num_sweeps=4), device="cpu", **kw)


def _data(rng, shape=(6,)):
    x = rng.uniform(0, 1, (24,) + shape).astype("float32")
    return x, rng.integers(0, 2, 24).astype("float32")


def _leaves(params):
    return [leaf for _, leaf in tck._leaves_with_keys(params)]


def _assert_same_run(a, b, hist_a, hist_b):
    for x, y in zip(_leaves(a.params), _leaves(b.params), strict=True):
        assert torch.equal(x, y)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    for series in ("nll_per_epoch", "nll_per_batch", "acc_per_epoch", "auc_per_epoch",
                   "errors_per_batch", "prob_auc_per_epoch"):
        assert getattr(hist_a, series) == getattr(hist_b, series), series


@pytest.mark.parametrize("model", ["dqbm", "cdqbm probabilistic", "cdqbm deterministic"])
def test_resume_is_bit_identical(tmp_path, model):
    """4 epochs straight = 2 epochs with ``checkpoint_every=1``, then a fresh
    model (a new process's stand-in) loaded from the state for epochs 3-4."""
    rng = np.random.default_rng(0)
    if model == "dqbm":
        make, (x, y), bs = _dqbm, _data(rng), 8
    else:
        make, (x, y), bs = (lambda: _cdqbm(model.split()[1])), _data(rng, (6, 6)), 6
    train = dict(batch_size=bs, learning_rate=0.2, verbose=False)
    mA = make()
    histA = tloop.train_model(mA, x, y, x, y, epochs=4, **train)
    ck = str(tmp_path / "state")
    tloop.train_model(make(), x, y, x, y, epochs=2, checkpoint_every=1, checkpoint_path=ck,
                      **train)
    mC = make()
    hist, ep = tck.load_checkpoint(ck, mC)
    assert ep == 2 and len(hist.nll_per_epoch) == 2
    histC = tloop.train_model(mC, x, y, x, y, epochs=4, history=hist, start_epoch=ep, **train)
    _assert_same_run(mA, mC, histA, histC)


def test_checkpoint_refuses_another_model_class(tmp_path):
    x, y = _data(np.random.default_rng(1))
    ck = str(tmp_path / "state")
    tloop.train_model(_dqbm(), x, y, x, y, batch_size=8, learning_rate=0.2, epochs=1,
                      verbose=False, checkpoint_every=1, checkpoint_path=ck)
    with pytest.raises(ValueError, match="DiscQBM"):
        tck.load_checkpoint(ck, _cdqbm())


def test_checkpoint_refuses_a_missing_key_and_a_shape_mismatch(tmp_path):
    ck = tmp_path / "state"
    tck.save_checkpoint(ck, _dqbm())
    with pytest.raises(ValueError, match="shape mismatch for .w_vh"):
        tck.load_checkpoint(ck, td.DiscQBM(dim_input=5, n_hidden_nodes=3, device="cpu"))
    data = dict(np.load(f"{ck}.npz"))
    del data["param:.w_hh"]
    np.savez(tmp_path / "cut.npz", **data)
    with pytest.raises(KeyError, match="w_hh"):
        tck.load_checkpoint(tmp_path / "cut.npz", _dqbm())


def test_crash_saves_a_mid_epoch_state(tmp_path, monkeypatch):
    x, y = _data(np.random.default_rng(2))
    m = _dqbm()
    ck = str(tmp_path / "state")
    tloop.train_model(m, x, y, x, y, batch_size=8, learning_rate=0.2, epochs=2, verbose=False,
                      checkpoint_every=1, checkpoint_path=ck)

    def boom(*a, **k):
        raise RuntimeError("injected mid-run failure")

    monkeypatch.setattr(m, "train_epoch", boom)
    with pytest.raises(RuntimeError, match="injected"):
        tloop.train_model(m, x, y, x, y, batch_size=8, learning_rate=0.2, epochs=4,
                          verbose=False, start_epoch=2, checkpoint_every=1, checkpoint_path=ck,
                          save_folder=str(tmp_path / "run"))
    assert (tmp_path / "state_crash.npz").exists() and (tmp_path / "run" / "e3_crash.pkl").exists()
    with pytest.raises(ValueError, match="mid-epoch"):
        tck.load_checkpoint(tmp_path / "state_crash", _dqbm())
    _, ep = tck.load_checkpoint(tmp_path / "state_crash", _dqbm(), allow_mid_epoch=True)
    assert ep == 2  # the last completed epoch


def test_keyboard_interrupt_writes_the_crash_state(tmp_path, monkeypatch):
    m = _dqbm()
    calls = []

    def interrupted(*a):
        calls.append(1)
        if len(calls) >= 2:
            raise KeyboardInterrupt
        return np.zeros(2), np.zeros(2)

    monkeypatch.setattr(m, "train_epoch", interrupted)
    x, y = np.zeros((8, 6), "float32"), np.zeros(8, "float32")
    with pytest.raises(KeyboardInterrupt):
        tloop.train_model(m, x, y, batch_size=4, learning_rate=0.1, epochs=5, verbose=False,
                          checkpoint_every=10, checkpoint_path=str(tmp_path / "state"))
    assert (tmp_path / "state_crash.npz").exists()
    _, ep = tck.load_checkpoint(tmp_path / "state_crash", _dqbm(), allow_mid_epoch=True)
    assert ep == 1


def test_reinit_attempt_survives_resume(tmp_path):
    """A resumed run continues the flatline-recovery counter, and its next
    re-draw takes the next attempt."""
    rng = np.random.default_rng(3)
    x, y = rng.uniform(0, 1, (12, 4)).astype("float32"), np.zeros(12, "float32")

    def mk():
        return td.DiscQBM(dim_input=4, n_hidden_nodes=2, seed=0, sample_count=8,
                          restricted=False, sampler=get_sampler("SA-TORCH", num_sweeps=4),
                          device="cpu")

    mA, ck = mk(), str(tmp_path / "state")
    # majority fraction 1.0: always stuck; re-draws after epochs 1 and 2, not 3
    tloop.train_model(mA, x, y, x, y, batch_size=6, learning_rate=0.0, epochs=3, verbose=False,
                      reinit_on_collapse=1, checkpoint_every=1, checkpoint_path=ck)
    assert mA._reinit_attempt == 2
    mB = mk()
    hist, ep = tck.load_checkpoint(ck, mB)
    assert ep == 3 and mB._reinit_attempt == 2
    attempts = []
    orig = mB.reinit_params
    mB.reinit_params = lambda attempt: (attempts.append(attempt), orig(attempt))
    tloop.train_model(mB, x, y, x, y, batch_size=6, learning_rate=0.0, epochs=5, verbose=False,
                      history=hist, start_epoch=ep, reinit_on_collapse=1)
    assert attempts == [3]


PINNED_KEYS = {
    "dqbm": [".w_vh", ".w_vo", ".w_oo", ".b_h", ".b_o", ".w_hh"],
    "cdqbm": [".kernel", ".w_seq/[0]", ".w_seq/[1]", ".w_seq_intra/[0]", ".w_seq_intra/[1]",
              ".w_h2o", ".w_oo", ".b_conv", ".b_seq", ".b_o"],
    "cdqbm learn_penalty": [".kernel", ".w_seq/[0]", ".w_seq_intra/[0]", ".w_h2o", ".w_oo",
                            ".b_conv", ".b_seq", ".b_o", ".pen"],
    "rbm": [".weights", ".visible_bias", ".hidden_bias", ".class_bias", ".class_weights"],
}


def _pair(kind):
    """(qbmx model, port model) of one configuration."""
    if kind == "dqbm":
        kw = dict(dim_input=6, n_hidden_nodes=3, restricted=False)
        return jd.DiscQBM(**kw), td.DiscQBM(device="cpu", **kw)
    if kind == "rbm":
        kw = dict(num_visible=7, num_hidden=3, num_classes=3)
        return jr.ClassificationRBM(**kw), tr.ClassificationRBM(device="cpu", **kw)
    kw = dict(image_shape=(8, 8), pooling_size=2, sequential_layer_sizes=[3, 2])
    if kind == "cdqbm learn_penalty":
        kw = dict(image_shape=(8, 8), pooling_size=2, pooling_type="probabilistic",
                  learn_penalty=True, sequential_layer_sizes=[3])
    return jc.CDQBM(**kw), tc.CDQBM(device="cpu", **kw)


@pytest.mark.parametrize("kind", sorted(PINNED_KEYS))
def test_param_keys_are_qbmx_keys(kind):
    jm, tm = _pair(kind)
    assert list(tck.flatten_params(tm.params)) == list(jck._flatten_params(jm.params)) \
        == PINNED_KEYS[kind]


@pytest.mark.parametrize("kind", sorted(PINNED_KEYS))
def test_qbmx_checkpoint_params_history_and_epoch_load_into_the_port(tmp_path, kind):
    """A ``qbmx``-written state: ``load_checkpoint`` refuses it (no torch
    Generator state), ``load_checkpoint_params`` reads its parameters,
    history and epoch exactly."""
    jm, tm = _pair(kind)
    jh = jloop.History(nll_per_epoch=[0.5, 0.25], acc_per_epoch=[0.75, 1.0])
    jck.save_checkpoint(tmp_path / "j", jm, jh, epoch=2)
    state = tm.generator.get_state()
    with pytest.raises(ValueError, match="qbmx checkpoint"):
        tck.load_checkpoint(tmp_path / "j", tm)
    hist, ep = tck.load_checkpoint_params(tmp_path / "j", tm)
    assert ep == 2 and hist.nll_per_epoch == [0.5, 0.25] and hist.acc_per_epoch == [0.75, 1.0]
    want = jck._flatten_params(jm.params)
    for key, leaf in tck.flatten_params(tm.params).items():
        assert np.array_equal(leaf, want[key]), key
    assert torch.equal(tm.generator.get_state(), state)  # the stream is untouched


@pytest.mark.parametrize("kind", sorted(PINNED_KEYS))
def test_port_checkpoint_params_load_into_a_qbmx_tree(tmp_path, kind):
    """A port-written state's ``param:`` arrays fill a ``qbmx`` model's
    parameter tree by its own key paths, and its history reads back."""
    jm, tm = _pair(kind)
    tck.save_checkpoint(tmp_path / "t", tm, tloop.History(nll_per_epoch=[0.5]), epoch=1)
    data = np.load(tmp_path / "t.npz")
    paths, treedef = jax.tree_util.tree_flatten_with_path(jm.params)
    keys = ["/".join(str(p) for p in path) for path, _ in paths]
    jm.params = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(data[f"param:{k}"]) for k in keys])
    got = jck._flatten_params(jm.params)
    for key, leaf in tck.flatten_params(tm.params).items():
        assert np.array_equal(got[key], leaf), key
    meta = json.loads(bytes(data["meta_json"]).decode())
    assert meta["epoch"] == 1 and meta["model_class"] == type(jm).__name__
    h = jloop.History(**{k: meta["history"].get(k, []) for k in jloop.History.__dataclass_fields__})
    assert h.nll_per_epoch == [0.5]


QBM_SMALL = dict(data_set="synthetic", n_hidden_nodes=2, sample_count=4, anneal=2,
                 batch_size=200, epochs=1)
CDQBM_SMALL = dict(data_set="synthetic", kernel_size=20, pooling_size=3, sample_count=2,
                   anneal=2, batch_size=200, epochs=1, pooling_type="probabilistic")


@pytest.mark.parametrize("kw,match", [
    (dict(seed_sweep=[1, 2], resume="state.npz"), "--resume/--checkpoint_every need"),
    (dict(resume="state.npz", load_path="w.pkl"), "both set initial"),
    (dict(checkpoint_every=1), "--checkpoint_every needs --save"),
])
def test_qbm_main_guards_raise_as_in_qbmx(kw, match):
    for main, extra in ((jmain.main, {}), (tmain.main, {"device": "cpu"})):
        with pytest.raises(ValueError, match=match):
            main(save="", **QBM_SMALL, **kw, **extra)


def test_cdqbm_main_guards_raise_as_in_qbmx():
    """``--checkpoint_every`` needs ``--save``; the seed sweep's guards are
    in ``tests/test_torch_cdqbm_sweep.py``."""
    for main, extra in ((jcmain.main, {}), (tcmain.main, {"device": "cpu"})):
        with pytest.raises(ValueError, match="--checkpoint_every needs --save"):
            main(save="", checkpoint_every=1, **CDQBM_SMALL, **extra)


@pytest.mark.parametrize("cli", ["qbm_main", "cdqbm_main"])
def test_cli_resume_continues_exactly(tmp_path, cli):
    """``--epochs 2 --checkpoint_every 1`` against ``--epochs 1
    --checkpoint_every 1`` then ``--resume <state> --epochs 2``: the same
    epoch-2 weights and test metrics."""
    main, small = ((tmain.main, QBM_SMALL) if cli == "qbm_main"
                   else (tcmain.main, CDQBM_SMALL))
    kw = {**small, "device": "cpu", "seed": 4}
    whole = main(save=f"{tmp_path}/a/", checkpoint_every=1, **{**kw, "epochs": 2})
    main(save=f"{tmp_path}/b/", checkpoint_every=1, **kw)
    (state,) = (tmp_path / "b").glob("*/state.npz")
    resumed = main(save=f"{tmp_path}/c/", resume=str(state), **{**kw, "epochs": 2})
    assert resumed == whole
    (wa,), (wc,) = ((tmp_path / d).glob("*/e2.pkl") for d in ("a", "c"))
    _assert_same_objects(pickle.load(open(wa, "rb")), pickle.load(open(wc, "rb")))
    (sa,) = (tmp_path / "a").glob("*/state.npz")
    model = (td.DiscQBM(dim_input=784, n_hidden_nodes=2, restricted=True, device="cpu")
             if cli == "qbm_main" else
             tc.CDQBM(kernel_size=20, pooling_size=3, pooling_type="probabilistic",
                      sequential_layer_sizes=[4], device="cpu"))
    assert tck.load_checkpoint_params(sa, model)[1] == 2


def _assert_same_objects(a, b):
    """Two weight-pickle payloads equal: arrays bit for bit, lists of them,
    ``None``."""
    if isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same_objects(x, y)
    elif a is None:
        assert b is None
    else:
        assert np.array_equal(np.asarray(a), np.asarray(b))


def _rbm(**kw):
    return tr.ClassificationRBM(num_visible=6, num_hidden=3, seed=9, learning_rate=0.2,
                                device="cpu", **kw)


@pytest.mark.parametrize("kw", [dict(), dict(method="generative", compute_dtype=torch.bfloat16),
                                dict(method="hybrid", generative_factor=0.1)],
                         ids=["discriminative f32", "CD-1 bf16", "hybrid"])
def test_rbm_resume_is_bit_identical(tmp_path, kw):
    """4 epochs straight (shuffled, every epoch checkpointed) against 2
    epochs, then a fresh model loaded from the epoch-2 state for epochs
    3-4: parameters, generator state and the acc/auc/nll lists equal."""
    rng = np.random.default_rng(1)
    x, y = (rng.random((27, 6)) > 0.5).astype("float32"), rng.integers(0, 2, 27)
    whole = _rbm(**kw)
    whole.train_rbm(x, y, epochs=4, batch_size=5, test_x=x, test_y=y, checkpoint_every=1,
                    checkpoint_path=str(tmp_path / "a"))
    first = _rbm(**kw)
    first.train_rbm(x, y, epochs=2, batch_size=5, test_x=x, test_y=y, checkpoint_every=2,
                    checkpoint_path=str(tmp_path / "b"))
    resumed = _rbm(**kw)
    hist, ep = tck.load_checkpoint(tmp_path / "b", resumed)
    assert ep == 2 and hist.acc_per_epoch == first.acc_per_epoch_list
    resumed.acc_per_epoch_list = list(hist.acc_per_epoch)
    resumed.auc_per_epoch_list = list(hist.auc_per_epoch)
    resumed.nll_per_epoch_list = list(hist.nll_per_epoch)
    resumed.train_rbm(x, y, epochs=4, batch_size=5, test_x=x, test_y=y, start_epoch=ep)
    for a, b in zip(_leaves(whole.params), _leaves(resumed.params), strict=True):
        assert torch.equal(a, b)
    assert torch.equal(whole.generator.get_state(), resumed.generator.get_state())
    for name in ("acc_per_epoch_list", "auc_per_epoch_list", "nll_per_epoch_list"):
        assert getattr(whole, name) == getattr(resumed, name), name
    meta = json.loads(bytes(np.load(tmp_path / "a.npz")["meta_json"]).decode())
    assert meta["model_class"] == "ClassificationRBM" and meta["epoch"] == 4


def test_rbm_checkpoint_round_trip_and_refusals(tmp_path):
    m = _rbm()
    m.params = tr.params_from_numpy({k: v + 1.5 for k, v in tr.params_to_numpy(m.params).items()})
    m._reinit_attempt = 3
    tck.save_checkpoint(tmp_path / "s", m, tloop.History(nll_per_epoch=[0.5]), epoch=1)
    fresh = _rbm()
    hist, ep = tck.load_checkpoint(tmp_path / "s", fresh)
    assert ep == 1 and hist.nll_per_epoch == [0.5] and fresh._reinit_attempt == 3
    for a, b in zip(_leaves(m.params), _leaves(fresh.params), strict=True):
        assert torch.equal(a, b)
    assert torch.equal(m.generator.get_state(), fresh.generator.get_state())
    with pytest.raises(ValueError, match="saved from ClassificationRBM"):
        tck.load_checkpoint(tmp_path / "s", _dqbm())
    with pytest.raises(ValueError, match="shape mismatch"):
        tck.load_checkpoint(tmp_path / "s", tr.ClassificationRBM(6, 4, device="cpu"))
    with pytest.raises(ValueError, match="pcd"):
        _rbm(method="pcd").train_rbm(np.zeros((4, 6), "float32"), np.zeros(4), epochs=1,
                                     batch_size=2, checkpoint_every=1, checkpoint_path="x")


def test_rbm_main_resume_continues_exactly(tmp_path):
    """``rbm_main --epochs 2 --checkpoint_every 1`` against ``--epochs 1
    --checkpoint_every 1`` then ``--resume <state> --epochs 2``: the same
    per-epoch accuracy/AUC pickles and epoch-2 state."""
    base = ["--data_set", "synthetic", "--device", "cpu", "--seeds", "6",
            "--hidden-units", "3"]
    parse = trmain.build_parser().parse_args
    trmain.main(parse(base + ["--epochs", "2", "--checkpoint_every", "1",
                              "--out", str(tmp_path / "a")]))
    trmain.main(parse(base + ["--epochs", "1", "--checkpoint_every", "1",
                              "--out", str(tmp_path / "b")]))
    trmain.main(parse(base + ["--epochs", "2", "--checkpoint_every", "1",
                              "--resume", str(tmp_path / "b" / "state_se6.npz"),
                              "--out", str(tmp_path / "c")]))
    for name in ("acc_per_epoch6.pkl", "auc_per_epoch6.pkl"):
        a, c = (pickle.load(open(tmp_path / d / name, "rb")) for d in ("a", "c"))
        assert a == c and len(a) == 2
    sa, sc = (np.load(tmp_path / d / "state_se6.npz") for d in ("a", "c"))
    for k in sa.files:
        assert np.array_equal(sa[k], sc[k]), k
