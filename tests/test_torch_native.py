"""qbmx_torch.samplers.native (the ``"SA-NATIVE"`` solver) against
``qbmx.samplers.native``.

Both packages build the same ``native/sa_sampler.cpp`` with the same flags,
so on the same uint64 seeds and QUBOs their samples are equal bit for bit.
``qbmx``'s library is built here into a private directory (its own build
code, its own flags), so this file never races ``tests/test_native.py`` for
``native/_qbmx_sa.so``.  The port's lands in ``build/native/``.  The slice:
three ``DiscQBM`` steps and a prediction in each package on the same
per-problem seeds (the port's drawn from its generator, replayed into
``qbmx``'s native entry) equal within 1e-5.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qbmx.models.dqbm as jd
import qbmx.samplers.native as jnative
import qbmx_torch.models.dqbm as td
from qbmx.core.qubo import default_beta_range as j_beta_range
from qbmx_torch.core.rng import draw_seeds
from qbmx_torch.samplers import api
from qbmx_torch.samplers import native as tnative
from qbmx_torch.samplers.exact import exact_boltzmann
from test_torch_dqbm import _batch, _close, _close_tree, _jparams, _params

torch.set_num_threads(1)
ROOT = tnative.ROOT


@pytest.fixture(scope="module", autouse=True)
def qbmx_library(tmp_path_factory):
    """``qbmx``'s own build of the source, into a private path."""
    saved = jnative._LIB, jnative._lib
    jnative._LIB, jnative._lib = tmp_path_factory.mktemp("qbmx_native") / "_qbmx_sa.so", None
    yield jnative.load_library()
    jnative._LIB, jnative._lib = saved


def qubo_batch(seed, B, n, scale=1.0):
    rng = np.random.default_rng(seed)
    return np.stack([np.triu(rng.uniform(-scale, scale, (n, n)))
                     for _ in range(B)]).astype(np.float32)


def test_library_lands_in_build_native_under_a_content_name():
    path = tnative.library_path()
    assert path.parent == ROOT / "build" / "native"
    assert path.name.startswith("libqbmx_sa_") and path.suffix == ".so"
    tnative.load_library()
    assert path.exists()
    assert tnative.library_path() == path  # stable for an unchanged source and host


def test_a_changed_source_gets_another_library(tmp_path, monkeypatch):
    src = tmp_path / "sa_sampler.cpp"
    src.write_text(tnative.SRC.read_text())
    monkeypatch.setattr(tnative, "SRC", src)
    same = tnative.library_path()
    src.write_text(src.read_text() + "\n// edited\n")
    assert tnative.library_path() != same


def test_the_port_never_writes_qbmx_s_library(tmp_path, monkeypatch):
    """A fresh build goes to ``build/native/``; ``native/_qbmx_sa.so`` (qbmx's
    output path) is neither created nor touched."""
    qbmx_so = ROOT / "native" / "_qbmx_sa.so"
    before = qbmx_so.stat().st_mtime_ns if qbmx_so.exists() else None
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(tnative, "_lib", None)
    tnative.load_library()
    assert [p.name for p in (tmp_path / "native").iterdir()] == [tnative.library_path().name]
    after = qbmx_so.stat().st_mtime_ns if qbmx_so.exists() else None
    assert after == before


def test_a_failed_build_raises(tmp_path, monkeypatch):
    src = tmp_path / "sa_sampler.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SRC", src)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(tnative, "_lib", None)
    with pytest.raises(RuntimeError, match="failed"):
        tnative.load_library()


@pytest.mark.parametrize("B,n", [(4, 6), (3, 41)])
def test_seeds_entry_equals_qbmx_bit_for_bit(B, n):
    Q = qubo_batch(B * n, B, n)
    seeds = np.random.default_rng(n).integers(0, 2**63 - 1, B, dtype=np.int64).astype(np.uint64)
    seeds[0] = np.uint64(2**64 - 1)  # the top bit too
    ours = tnative.sa_sample_batch_native_seeds(seeds, Q, 32, 50)
    theirs = jnative.sa_sample_batch_native_seeds(seeds, Q, 32, 50)
    assert ours.dtype == np.float32 and ours.shape == (B, 32, n)
    np.testing.assert_array_equal(ours, theirs)


def test_single_seed_entry_equals_qbmx_bit_for_bit():
    Q = qubo_batch(1, 3, 7)
    np.testing.assert_array_equal(tnative.sa_sample_batch_native(42, Q, 16, 40),
                                  jnative.sa_sample_batch_native(42, Q, 16, 40))


@pytest.mark.parametrize("n", [1, 6, 20])
def test_beta_range_matches_qbmx(n):
    Q = qubo_batch(n, 1, n)[0]
    hot, cold = tnative.default_beta_range(Q)
    j_hot, j_cold = j_beta_range(jnp.asarray(Q))
    np.testing.assert_allclose([hot, cold], [float(j_hot), float(j_cold)], rtol=1e-5)


def test_marginals_match_the_oracle():
    """``tests/test_native.py``'s bound: each problem's marginals within
    0.35 of the exact ones at its cold beta, 256 reads of 500 sweeps."""
    B, n = 4, 6
    Q = qubo_batch(0, B, n)
    out = tnative.sa_sample_batch_native(7, Q, 256, 500)
    assert out.shape == (B, 256, n) and set(np.unique(out)) <= {0.0, 1.0}
    for b in range(B):
        _, cold = tnative.default_beta_range(Q[b])
        _, _, marg, _ = exact_boltzmann(torch.as_tensor(Q[b]), beta=cold)
        assert np.abs(out[b].mean(axis=0) - marg.numpy()).max() < 0.35


def test_reads_are_deterministic_given_seeds_and_per_problem():
    # a zero QUBO accepts every flip: a read is its chain's random start,
    # flipped once a sweep, so reads differ and show each chain's stream
    Q = np.zeros((3, 8, 8), np.float32)
    seeds = np.asarray([5, 6, 7], np.uint64)
    a = tnative.sa_sample_batch_native_seeds(seeds, Q, 32, 5)
    np.testing.assert_array_equal(a, tnative.sa_sample_batch_native_seeds(seeds, Q, 32, 5))
    assert len({tuple(r) for r in a[0]}) > 5
    b = tnative.sa_sample_batch_native_seeds(np.asarray([5, 6, 99], np.uint64), Q, 32, 5)
    np.testing.assert_array_equal(a[:2], b[:2])  # a problem's samples are its own
    assert not np.array_equal(a[2], b[2])
    alone = tnative.sa_sample_batch_native_seeds(seeds[1:2], Q[1:2], 32, 5)
    np.testing.assert_array_equal(a[1], alone[0])


def test_sampler_draws_its_seeds_from_the_generator():
    Q = torch.as_tensor(qubo_batch(3, 2, 5))
    s = tnative.NativeSASampler(num_sweeps=50)
    a = s.sample_batch(torch.Generator().manual_seed(1), Q, 16)
    np.testing.assert_array_equal(a, s.sample_batch(torch.Generator().manual_seed(1), Q, 16))
    want = tnative.sa_sample_batch_native_seeds(
        draw_seeds(torch.Generator().manual_seed(1), 2), Q.numpy(), 16, 50)
    np.testing.assert_array_equal(a.numpy(), want)
    flat = torch.zeros((2, 8, 8))  # every read its random start: the seeds show
    assert not torch.equal(s.sample_batch(torch.Generator().manual_seed(1), flat, 16),
                           s.sample_batch(torch.Generator().manual_seed(2), flat, 16))


@pytest.mark.parametrize("shape,seeds", [((2, 3), None), ((2, 4, 4), np.zeros(3, np.uint64))])
def test_bad_inputs_are_refused_before_the_call(shape, seeds):
    Q = np.zeros(shape, np.float32)
    with pytest.raises(ValueError):
        if seeds is None:
            tnative.sa_sample_batch_native(0, Q, 4, 4)
        else:
            tnative.sa_sample_batch_native_seeds(seeds, Q, 4, 4)


def test_registry_returns_the_native_sampler_and_keeps_the_device():
    s = api.get_sampler("SA-NATIVE", num_sweeps=30)
    assert isinstance(s, tnative.NativeSASampler) and s.num_sweeps == 30
    assert api.get_sampler("sa-native").num_sweeps == 1000
    out = s.sample_batch(torch.Generator().manual_seed(0), torch.as_tensor(qubo_batch(4, 2, 4)), 8)
    assert out.device.type == "cpu" and out.dtype == torch.float32 and out.shape == (2, 8, 4)


def test_structured_calls_densify_onto_the_native_sampler():
    """No ``sample_groups``: the models' structured calls reach
    ``sample_batch`` on the densified batch, as in ``qbmx``."""
    rng = np.random.default_rng(0)
    Qg = torch.as_tensor(qubo_batch(5, 2, 4))
    h = torch.as_tensor(rng.normal(size=(2, 3, 4)).astype(np.float32))
    s = tnative.NativeSASampler(num_sweeps=20)
    got = api.sampler_sample_groups(s, torch.Generator().manual_seed(3), Qg, h, 8)
    want = s.sample_batch(torch.Generator().manual_seed(3), api.densify_groups(Qg, h), 8)
    assert got.shape == (2, 3, 8, 4)
    np.testing.assert_array_equal(got.reshape(6, 8, 4).numpy(), want.numpy())


# -- the slice: matched DiscQBM steps on the same per-problem seeds -------------


class _RecordingNative(tnative.NativeSASampler):
    """The port's native sampler, keeping the seeds each call drew."""

    def __init__(self, num_sweeps, seeds):
        super().__init__(num_sweeps)
        self.seeds = seeds

    def sample_batch(self, generator, Q, num_reads):
        state = generator.get_state()
        out = super().sample_batch(generator, Q, num_reads)
        self.seeds.append(draw_seeds(torch.Generator().set_state(state), Q.shape[0]))
        return out


class _JaxNativeReplay:
    """qbmx's native entry on the seeds the port's sampler drew;
    host-bound, so qbmx builds its step eagerly."""

    jit_safe = False

    def __init__(self, num_sweeps, seeds):
        self.num_sweeps, self.seeds = num_sweeps, seeds

    def sample_batch(self, key, Q, num_reads):
        return jnp.asarray(jnative.sa_sample_batch_native_seeds(
            self.seeds.pop(0), np.asarray(Q), num_reads, self.num_sweeps))


@pytest.mark.parametrize("one_hot", [False, True])
def test_three_dqbm_steps_and_predict_match_qbmx(one_hot):
    D, H, B, R, S, N = 10, 3, 4, 8, 20, 6
    O = 2 if one_hot else 1
    seeds = []
    kw = dict(dim_input=D, n_hidden_nodes=H, sample_count=R, anneal_steps=S,
              use_one_hot_encoding=one_hot)
    jm = jd.DiscQBM(sampler=_JaxNativeReplay(S, seeds), **kw)
    tm = td.DiscQBM(sampler=_RecordingNative(S, seeds), device="cpu", **kw)
    d = _params(8, D, H, O)
    jm.params, tm.params = _jparams(d), td.params_from_numpy(d)
    for step in range(3):
        x, y, _ = _batch(10 + step, B, D, O, one_hot)
        terr, tnll = tm.train_for_one_iteration(x, y, 0.3)
        jerr, jnll = jm.train_for_one_iteration(x, y, 0.3)
        assert not seeds  # every call the port made was replayed
        _close(float(tnll), float(jnll), rtol=0, atol=1e-5)
        _close(float(terr), float(jerr), rtol=0, atol=1e-5)
        _close_tree(tm.params, jm.params, rtol=0, atol=1e-5)
    X = np.random.default_rng(20).random((N, D)).astype(np.float32)
    tpred, tprob = tm.predict_batch(X)
    jpred, jprob = jm.predict_batch(X)
    np.testing.assert_array_equal(tpred, jpred)
    _close(tprob, jprob, rtol=0, atol=1e-5)


def test_seed_sweep_takes_the_native_sampler():
    """``qbmx`` refuses host-bound samplers in its sweeps for tracing; the
    port's steps are eager, so the sweep runs ``SA-NATIVE``."""
    from qbmx_torch.train.sweep import SeedParallelDQBM

    rng = np.random.default_rng(0)
    x, y = rng.random((12, 6)).astype(np.float32), np.arange(12) % 2
    sweep = SeedParallelDQBM([0, 1], dim_input=6, n_hidden_nodes=2, sample_count=8,
                             anneal_steps=10, solver="SA-NATIVE", device="cpu")
    assert isinstance(sweep.sampler, tnative.NativeSASampler)
    hists = sweep.train(x, y, x, y, epochs=1, batch_size=6, learning_rate=0.1)
    assert len(hists) == 2 and all(np.isfinite(h.nll_per_batch).all() for h in hists)


def test_qbm_main_runs_sa_native_on_the_cpu(capsys):
    from qbmx_torch.cli import qbm_main

    acc, f1, precision, recall, auc = qbm_main.main(
        data_set="synthetic", n_hidden_nodes=2, sample_count=8, anneal=10, batch_size=100,
        epochs=1, save="", solver="SA-NATIVE", device="cpu")
    assert all(0.0 <= v <= 1.0 for v in (acc, f1, precision, recall, auc))
    assert "Epoch 1/1" in capsys.readouterr().out
