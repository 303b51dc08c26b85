"""The plain PyTorch heat-bath sampler (qbmx_torch.samplers.gibbs) and the
BMS registry entry against qbmx.

Under host variates the plain sweeps (single, pair, quad) must equal
qbmx's XLA sweeps ``gibbs._heat_bath_sweep`` / ``_pair_…`` / ``_quad_…``,
and the plain anneal must equal the TPU kernels run in interpret mode
(``lane_sample_groups(rule="heatbath")`` and ``gibbs_sample_batch_pallas``
with ``debug_randoms``) EXACTLY.  The generator path is held against the
exact oracle with the bounds of tests/test_gibbs_pt_pallas_debug.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qbmx.samplers import gibbs as jgibbs
from qbmx.samplers.sa_lane import lane_geometry, lane_sample_groups
from qbmx.samplers.sa_pallas import gibbs_sample_batch_pallas
from qbmx_torch.core.qubo import split_qubo
from qbmx_torch.samplers import api, gibbs, gibbs_cuda
from qbmx_torch.samplers.exact import exact_boltzmann

torch.set_num_threads(1)
T = torch.as_tensor


def _structured(seed, G, B, n, R, S):
    rng = np.random.default_rng(seed)
    Qg = np.triu(rng.uniform(-1, 1, (G, n, n))).astype(np.float32)
    h_extra = rng.normal(size=(G, B, n)).astype(np.float32)
    init01 = (rng.random((G, B, R, n)) < 0.5).astype(np.float32)
    u = rng.random((S, G, B, n, R)).astype(np.float32)
    return Qg, h_extra, init01, u


def _dense(seed, B, n, R, S):
    rng = np.random.default_rng(seed)
    Q = np.triu(rng.uniform(-2, 2, (B, n, n))).astype(np.float32)
    init01 = (rng.uniform(0, 1, (B, R, n)) < 0.5).astype(np.float32)
    u = rng.uniform(0, 1, (S, B, n, R)).astype(np.float32)
    return Q, init01, u


SWEEPS = {"single": (gibbs.heat_bath_sweep, jgibbs._heat_bath_sweep),
          "pair": (gibbs.pair_heat_bath_sweep, jgibbs._pair_heat_bath_sweep),
          "quad": (gibbs.quad_heat_bath_sweep, jgibbs._quad_heat_bath_sweep)}


@pytest.mark.parametrize("n,R", [(5, 9), (6, 7), (7, 5), (10, 6), (41, 4), (2, 8), (1, 3)])
@pytest.mark.parametrize("width", ["single", "pair", "quad"])
@pytest.mark.parametrize("beta", [0.7, 3.0])
def test_sweep_matches_xla_sweep(n, R, width, beta):
    """One sweep at a fixed beta, odd n and n ≡ 1, 2, 3 (mod 4) included."""
    Q, init01, u = _dense(31 * n + R, 1, n, R, 3)
    h, J = split_qubo(T(Q[0]))
    ours, theirs = SWEEPS[width]
    s_t, s_j = T(init01[0]).clone(), jnp.asarray(init01[0])
    for t in range(3):  # three sweeps: later ones start from mixed states
        ours(s_t, T(u[t, 0]), np.float32(beta), h, J)
        s_j = theirs(s_j, jnp.asarray(u[t, 0]), np.float32(beta), jnp.asarray(h.numpy()),
                     jnp.asarray(J.numpy()))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))


def test_quad_pairs_match():
    assert gibbs._QUAD_PAIRS == jgibbs._QUAD_PAIRS


@pytest.mark.parametrize("G,B,n,R,S", [
    (2, 5, 11, 7, 6),   # tests/test_sa_lane.py:73 shapes
    (1, 3, 8, 9, 4),
    (3, 2, 21, 5, 5),
    (1, 1, 3, 1, 3),
    (2, 3, 11, 7, 5),   # tests/test_sa_lane.py:267 shapes
    (1, 2, 8, 9, 4),
])
@pytest.mark.parametrize("pair", [False, True])
def test_groups_match_lane_kernel(G, B, n, R, S, pair):
    """The warm-up ramp min(default_hot, β) → β of ``GibbsSampler.sample_groups``."""
    Qg, h_extra, init01, u = _structured(G * 100 + n + S, G, B, n, R, S)
    beta = 1.5
    want = lane_sample_groups(
        jax.random.key(0), jnp.asarray(Qg), jnp.asarray(h_extra), R, S, rule="heatbath",
        beta_cold=jnp.full((G, B), beta, jnp.float32), pair=pair, interpret=True,
        debug_randoms=(jnp.asarray(init01), jnp.asarray(u)))
    got = gibbs.gibbs_sample_groups_plain(T(Qg), T(h_extra), R, S, beta=beta, pair=pair,
                                          host_variates=(T(init01), T(u)))
    assert tuple(got.shape) == (G, B, R, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("pair", [False, True])
def test_wide_groups_match_lane_kernel(pair):
    """n = 300, above the 241 where the card switches from K2 to K4: the
    plain heat-bath equals the lane kernel (fold 2) in interpret mode
    exactly."""
    G, B, n, R, S = 2, 2, 300, 4, 3
    assert lane_geometry(n, B, R, groups=G)[3] == 2
    Qg, h_extra, init01, u = _structured(7 + pair, G, B, n, R, S)
    want = lane_sample_groups(
        jax.random.key(0), jnp.asarray(Qg), jnp.asarray(h_extra), R, S, rule="heatbath",
        beta_cold=jnp.full((G, B), 1.5, jnp.float32), pair=pair, interpret=True,
        debug_randoms=(jnp.asarray(init01), jnp.asarray(u)))
    got = gibbs.gibbs_sample_groups_plain(T(Qg), T(h_extra), R, S, beta=1.5, pair=pair,
                                          host_variates=(T(init01), T(u)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("width,n,B,R,S", [
    ("single", 5, 3, 16, 8),
    ("single", 14, 2, 8, 6),
    ("single", 20, 8, 8, 6),
    ("single", 41, 1, 4, 4),
    ("single", 6, 2, 8, 1),     # one sweep runs at the target beta
    ("pair", 20, 8, 8, 6),
    ("pair", 41, 1, 4, 4),
    ("pair", 5, 3, 8, 6),
    ("pair", 6, 2, 8, 1),
    ("quad", 20, 8, 8, 6),
    ("quad", 41, 1, 4, 4),
    ("quad", 5, 3, 8, 6),
    ("quad", 7, 2, 8, 5),
    ("quad", 10, 2, 8, 4),
    ("quad", 7, 2, 8, 1),
])
def test_batch_matches_packed_kernel(width, n, B, R, S):
    """Shapes at which the packed kernel does not demote quad or pair."""
    Q, init01, u = _dense(n * 37 + B + S, B, n, R, S)
    flags = dict(pair=width == "pair", quad=width == "quad")
    want = gibbs_sample_batch_pallas(jax.random.key(0), jnp.asarray(Q), R, S, beta=1.0,
                                     interpret=True, **flags,
                                     debug_randoms=(jnp.asarray(init01), jnp.asarray(u)))
    got = gibbs.gibbs_sample_batch_plain(T(Q), R, S, beta=1.0, **flags,
                                         host_variates=(T(init01), T(u)))
    assert tuple(got.shape) == (B, R, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_schedule_matches_the_kernels_form():
    """hot = min(default_hot, β) per problem on the effective QUBO; logr =
    log(β/hot); one sweep runs at β."""
    Qg, h_extra, _, _ = _structured(5, 2, 3, 6, 1, 1)
    hs, J = split_qubo(T(Qg))
    h = hs[:, None] + T(h_extra)
    d_hot, _ = gibbs.beta_range_from_parts(h, J[:, None])
    for beta in (0.01, 100.0):
        hot, logr = gibbs.heat_bath_schedule(h, J[:, None], 8, beta)
        assert torch.equal(hot, torch.minimum(d_hot, torch.tensor(beta)))
        assert torch.equal(logr, torch.log(torch.tensor(beta) / hot))
    hot, logr = gibbs.heat_bath_schedule(h, J[:, None], 1, 0.01)
    assert torch.all(hot == np.float32(0.01)) and torch.all(logr == 0.0)


@pytest.mark.parametrize("width", ["single", "pair", "quad"])
def test_generator_path_matches_oracle(width):
    """tests/test_gibbs_pt_pallas_debug.py's problems and bars: marginals
    within 0.08 (single) / 0.05 (pair, quad), pair moments within 0.07."""
    if width == "single":
        rng = np.random.default_rng(9)
        Q = T(np.triu(rng.uniform(-1, 1, (1, 6, 6))).astype(np.float32))
        reads, sweeps, atol = 384, 48, 0.08
    else:
        rng = np.random.default_rng(11)
        Q = T(np.triu(rng.uniform(-1, 1, (6, 6))).astype(np.float32))[None]
        reads, sweeps, atol = 2048, 64, 0.05
    s = gibbs.gibbs_sample_batch_plain(Q, reads, sweeps, beta=1.0, pair=width == "pair",
                                       quad=width == "quad",
                                       generator=torch.Generator().manual_seed(4))[0]
    _, _, marg, pair_m = exact_boltzmann(Q[0], beta=1.0)
    assert set(s.unique().tolist()) <= {0.0, 1.0}
    assert torch.allclose(s.mean(0), marg, atol=atol)
    if width != "single":
        assert torch.allclose(s.T @ s / reads, pair_m, atol=0.07)


def test_generator_path_is_reproducible_and_per_seed():
    Q, _, _ = _dense(3, 2, 5, 1, 1)
    run = lambda seed: gibbs.gibbs_sample_batch_plain(
        T(Q), 16, 6, pair=True, generator=torch.Generator().manual_seed(seed))
    assert torch.equal(run(1), run(1)) and not torch.equal(run(1), run(2))


def test_host_variates_shape_is_checked():
    Q, init01, u = _dense(10, 2, 5, 4, 3)
    with pytest.raises(ValueError, match="host_variates"):
        gibbs.gibbs_sample_batch_plain(T(Q), 4, 3, host_variates=(T(init01), T(u[:2])))


def test_wrappers_run_the_plain_version_on_cpu():
    """On CPU tensors the kernel wrappers run the plain version and launch
    nothing."""
    Qg, h_extra, init01, u = _structured(8, 2, 3, 7, 4, 3)
    gibbs_cuda.reset_launch_counts()
    for width in (1, 2, 4):
        flags = dict(pair=width == 2, quad=width == 4)
        got = gibbs_cuda.gibbs_sample_groups_cuda(T(Qg), T(h_extra), 4, 3, **flags,
                                                  host_variates=(T(init01), T(u)))
        want = gibbs.gibbs_sample_groups_plain(T(Qg), T(h_extra), 4, 3, **flags,
                                               host_variates=(T(init01), T(u)))
        assert torch.equal(got, want)
        Q, i1, u1 = _dense(9, 2, 5, 4, 3)
        assert torch.equal(
            gibbs_cuda.gibbs_sample_batch_cuda(T(Q), 4, 3, **flags, host_variates=(T(i1), T(u1))),
            gibbs.gibbs_sample_batch_plain(T(Q), 4, 3, **flags, host_variates=(T(i1), T(u1))))
    assert gibbs_cuda.launch_counts == {"sa_heatbath": 0}


# -- the registry ------------------------------------------------------------


def test_registry_bms_takes_qbmx_kwargs():
    s = api.get_sampler("BMS", num_sweeps=7)
    assert isinstance(s, api.GibbsSampler) and s.num_warmup == 7 and s.beta == 1.0
    s = api.get_sampler("bms", num_sweeps=7, num_warmup=3, beta=2.0, pair_updates=False,
                        quad_updates=True)
    assert (s.num_warmup, s.beta, s.pair_updates, s.quad_updates) == (3, 2.0, False, True)


@pytest.mark.parametrize("pair_updates,quad_updates,on_kernel,want", [
    (None, None, True, (True, False)),     # pairs where the kernel runs
    (None, None, False, (False, False)),   # single sweeps on the plain route
    (True, None, False, (True, False)),
    (False, None, True, (False, False)),
    (False, True, True, (False, True)),    # quad wins over pair_updates
    (None, True, False, (False, True)),
    (True, False, True, (True, False)),
])
def test_bms_update_width(pair_updates, quad_updates, on_kernel, want):
    s = api.GibbsSampler(pair_updates=pair_updates, quad_updates=quad_updates)
    assert s.widths(on_kernel) == want


def test_bms_routes_cpu_tensors_to_the_plain_version(monkeypatch):
    """On CPU tensors both entries run the plain version with the plain
    route's widths; the structured entry stays structured."""
    seen = []
    monkeypatch.setattr(gibbs, "gibbs_sample_groups_plain",
                        lambda *a, **k: seen.append(("groups", k["pair"], k["quad"])))
    monkeypatch.setattr(gibbs, "gibbs_sample_batch_plain",
                        lambda *a, **k: seen.append(("batch", k["pair"], k["quad"])))
    Qg = torch.zeros((2, 4, 4))
    api.GibbsSampler(num_warmup=3).sample_groups(None, Qg, torch.zeros((2, 3, 4)), 5)
    api.GibbsSampler(num_warmup=3, quad_updates=True).sample_batch(None, Qg, 5)
    assert seen == [("groups", False, False), ("batch", False, True)]


# -- the slice: matched-variate Disc_QBM steps with BMS -----------------------


class _JaxLaneReplay:
    """qbmx sampler that hands the TPU lane kernel's heat-bath pair mode
    (interpret mode) the next set of host variates; host-bound, so qbmx
    builds its step eagerly."""

    jit_safe = False

    def __init__(self, variates, sweeps, beta):
        self.variates, self.sweeps, self.beta = list(variates), sweeps, beta

    def sample_groups(self, key, Q_shared, h_extra, num_reads):
        init01, u = self.variates.pop(0)
        return lane_sample_groups(
            key, Q_shared, h_extra, num_reads, self.sweeps, rule="heatbath", pair=True,
            beta_cold=jnp.full(h_extra.shape[:2], self.beta, jnp.float32), interpret=True,
            debug_randoms=(jnp.asarray(init01), jnp.asarray(u)))


class _TorchReplay:
    """The port's counterpart: the plain structured heat-bath, pairs."""

    def __init__(self, variates, sweeps, beta):
        self.variates, self.sweeps, self.beta = list(variates), sweeps, beta

    def sample_groups(self, generator, Q_shared, h_extra, num_reads):
        init01, u = self.variates.pop(0)
        return gibbs.gibbs_sample_groups_plain(
            Q_shared, h_extra, num_reads, self.sweeps, beta=self.beta, pair=True,
            host_variates=(torch.as_tensor(init01), torch.as_tensor(u)))


@pytest.mark.parametrize("one_hot,restricted,shortcut", [
    (False, False, False),
    (True, False, False),
    (False, True, True),    # linear shortcut: only the unclamped group is sampled
])
def test_three_bms_steps_and_predict_match(one_hot, restricted, shortcut):
    import qbmx.models.dqbm as jd
    import qbmx_torch.models.dqbm as td
    from test_torch_dqbm import _batch, _close, _close_tree, _jparams, _params

    D, H, B, R, S, N, beta = 10, 3, 4, 8, 5, 6, 1.0
    O = 2 if one_hot else 1
    n_u, G = O + H, 1 if shortcut else 2
    rng = np.random.default_rng(17)
    variates = [((rng.random((g, b, R, n_u)) < 0.5).astype(np.float32),
                 rng.random((S, g, b, n_u, R)).astype(np.float32))
                for g, b in [(G, B)] * 3 + [(1, N)]]
    kw = dict(dim_input=D, n_hidden_nodes=H, sample_count=R, anneal_steps=S,
              restricted=restricted, use_one_hot_encoding=one_hot, use_linear_shortcut=shortcut)
    jm = jd.DiscQBM(sampler=_JaxLaneReplay(variates, S, beta), **kw)
    tm = td.DiscQBM(sampler=_TorchReplay(variates, S, beta), device="cpu", **kw)
    d = _params(18, D, H, O, restricted)
    jm.params, tm.params = _jparams(d), td.params_from_numpy(d)
    for step in range(3):
        x, y, _ = _batch(30 + step, B, D, O, one_hot)
        mask = np.asarray([1, 1, 1, step != 2], np.float32)
        jerr, jnll = jm.train_for_one_iteration(x, y, 0.3, mask=mask)
        terr, tnll = tm.train_for_one_iteration(x, y, 0.3, mask=mask)
        _close(float(tnll), float(jnll), rtol=0, atol=1e-5)
        _close(float(terr), float(jerr), rtol=0, atol=1e-5)
        _close_tree(tm.params, jm.params, rtol=0, atol=1e-5)
    X = np.random.default_rng(21).random((N, D)).astype(np.float32)
    (tpred, tprob), (jpred, jprob) = tm.predict_batch(X), jm.predict_batch(X)
    np.testing.assert_array_equal(tpred, jpred)
    _close(tprob, jprob, rtol=0, atol=1e-5)
