"""The widths past K4's and K5's shared layouts (n > 3368), on the CPU,
against qbmx.

Where the card runs K4's global-field layout (``wide_cuda``, SA and BMS)
and K5's global path (``pt_wide_cuda``, PT), the CPU runs their plain
versions; ``qbmx`` runs its XLA samplers at these widths (``api.py``
routes past the packed kernel to ``sa_jax``, and its PT is XLA
``tempering``).  Under the same host variates the plain SA, BMS pair and PT
equal qbmx's XLA sweeps (``sa_jax._metropolis_sweep``,
``gibbs._pair_heat_bath_sweep``, and ``_pt_reference_trajectory`` over
``gibbs._heat_bath_sweep``, the mirror of ``tempering.pt_sample`` that
qbmx's own tests use) at n = 3369 and 4100, R = 2, S = 2, exactly: the
couplings lie on a grid of 1/2 with |Q_ij| ≤ 1, so every field and energy
is exact in float32 in any order and the packages' different sum orders
(a matmul here, a dot there) cannot split a near-tie.  The schedule is the
port's (``schedule_params``, which ``test_torch_sa.py`` holds to qbmx's
lane kernel bit for bit), handed to both.

The slice at full width: one flat ``DiscQBM`` step at H = 3400 (n = 3401,
``qbm_main -hn 3400``'s QUBO) with SA at sc 2, anneal 2 in both packages
from the same parameters and batch, each package's sampler replaying the
same host variates -- qbmx's through its XLA Metropolis sweeps, the
port's through the plain anneal the card's K4 global-field layout
replaces: parameters, nll and err within atol 1e-5 (``test_torch_dqbm.py``'s
bar for the slice).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_gibbs_pt_pallas_debug import _pt_reference_trajectory
from test_torch_dqbm import _batch, _close, _close_tree, _jparams, _params

import qbmx.models.dqbm as jd
from qbmx.core.qubo import split_qubo as j_split_qubo
from qbmx.samplers.gibbs import _pair_heat_bath_sweep
from qbmx.samplers.sa_jax import _metropolis_sweep
import qbmx_torch.models.dqbm as td
from qbmx_torch.core.qubo import split_qubo
from qbmx_torch.samplers import gibbs, pt_wide_cuda, sa_torch, tempering, wide_cuda

torch.set_num_threads(1)
T = torch.as_tensor
WIDTHS = [3369, 4100]  # past the shared layouts; 4100 past K5's 10-bit Philox block too


def _grid_problem(n, B, R, S, copies=1):
    """B dense QUBOs with couplings on a grid of 1/2 (|Q_ij| ≤ 1), their
    host variates for ``copies`` chains a read (PT: M rungs)."""
    rng = np.random.default_rng(n + B + copies)
    Q = np.triu(rng.integers(-2, 3, (B, n, n)) / 2).astype(np.float32)
    init01 = (rng.random((B * copies, R, n)) < 0.5).astype(np.float32)
    u = np.clip(rng.random((S, B * copies, n, R)), 1e-6, 1 - 1e-6).astype(np.float32)
    return Q, init01, u


def _betas(Q, S, rule):
    """(S, B) float32 betas of the port's schedule for the dense batch Q."""
    h, J = split_qubo(T(Q))
    h = h[:, None, :]
    J = J[:, None]
    hot, logr = (sa_torch.schedule_params(h, J, S) if rule == "metropolis"
                 else gibbs.heat_bath_schedule(h, J, S, 1.0))
    span = sa_torch.inv_span(S)
    return np.stack([(hot * torch.exp(logr * float(np.float32(t) * np.float32(span))))[:, 0]
                     .numpy() for t in range(S)])


def _xla_anneal(Q, init01, u, betas, sweep):
    """qbmx's XLA sweeps over each problem at the given betas."""
    out = []
    for b in range(Q.shape[0]):
        h, J = j_split_qubo(jnp.asarray(Q[b]))
        s = jnp.asarray(init01[b])
        for t in range(betas.shape[0]):
            s = sweep(s, jnp.asarray(u[t, b]), jnp.float32(betas[t, b]), h, J)
        out.append(np.asarray(s))
    return np.stack(out)


@pytest.mark.parametrize("n", WIDTHS)
def test_plain_sa_matches_qbmx_xla_past_the_shared_layout(n):
    B, R, S = 1, 2, 2
    assert n > wide_cuda.max_n() and wide_cuda.wide_geometry(1, B, R, n).layout == wide_cuda.GLOBAL
    Q, init01, u = _grid_problem(n, B, R, S)
    got = sa_torch.sa_sample_batch_plain(T(Q), R, S, host_variates=(T(init01), T(u)))
    want = _xla_anneal(Q, init01, u, _betas(Q, S, "metropolis"), _metropolis_sweep)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", WIDTHS)
def test_plain_bms_pair_matches_qbmx_xla_past_the_shared_layout(n):
    B, R, S = 1, 2, 2
    Q, init01, u = _grid_problem(n, B, R, S)
    got = gibbs.gibbs_sample_batch_plain(T(Q), R, S, beta=1.0, pair=True,
                                         host_variates=(T(init01), T(u)))
    want = _xla_anneal(Q, init01, u, _betas(Q, S, "heatbath"), _pair_heat_bath_sweep)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", WIDTHS)
def test_plain_pt_matches_qbmx_xla_past_the_shared_paths(n):
    B, M, R, S = 1, 3, 2, 2
    assert pt_wide_cuda.pt_wide_geometry(B, 1, M, R, n).path == pt_wide_cuda.GLOBAL
    Q, init01, u = _grid_problem(n, B, R, S, copies=M)
    swap_u = np.random.default_rng(n).random((S, B * M, R)).astype(np.float32)
    got = tempering.pt_sample_batch_plain(T(Q), R, S, num_replicas=M,
                                          host_variates=(T(init01), T(u), T(swap_u)))
    want = _pt_reference_trajectory(jnp.asarray(Q), init01, u, swap_u, M, S, 1.0)
    np.testing.assert_array_equal(got.numpy(), want)


class _XlaReplay:
    """qbmx sampler that anneals each problem of a structured call with
    qbmx's XLA Metropolis sweeps on the next host variates, at the port's
    schedule (host-bound: qbmx builds its step eagerly)."""

    jit_safe = False

    def __init__(self, variates, sweeps):
        self.variates, self.sweeps = list(variates), sweeps

    def sample_groups(self, key, Q_shared, h_extra, num_reads):
        init01, u = self.variates.pop(0)
        G, B = h_extra.shape[:2]
        n = Q_shared.shape[-1]
        eye = np.eye(n, dtype=np.float32)
        Qd = np.asarray(Q_shared)[:, None] + np.asarray(h_extra)[..., None] * eye  # (G, B, n, n)
        Qd = Qd.reshape(G * B, n, n)
        betas = _betas(Qd, self.sweeps, "metropolis")
        out = _xla_anneal(Qd, init01.reshape(G * B, num_reads, n),
                          u.reshape(self.sweeps, G * B, n, num_reads), betas, _metropolis_sweep)
        return jnp.asarray(out.reshape(G, B, num_reads, n))


class _TorchReplay:
    """The port's counterpart: the plain anneal on the same variates."""

    def __init__(self, variates, sweeps):
        self.variates, self.sweeps = list(variates), sweeps

    def sample_groups(self, generator, Q_shared, h_extra, num_reads):
        init01, u = self.variates.pop(0)
        return sa_torch.sa_sample_groups_plain(Q_shared, h_extra, num_reads, self.sweeps,
                                               host_variates=(T(init01), T(u)))


@pytest.mark.parametrize("restricted", [False, True])
def test_one_flat_step_at_h3400_matches_qbmx(restricted):
    """``qbm_main -hn 3400``'s model (n = 3401: 3400 hidden units and the
    output), one step at sc 2, anneal 2, a batch of 2: as the CLI runs it
    (``-r False``: a dense strictly-upper ``w_hh``, the card's dense pass)
    and restricted (``qm.main``'s default: ``w_hh`` zero, J_g all zeros but
    the output's row and column, the card's sparse pass)."""
    D, H, B, R, S, O = 6, 3400, 2, 2, 2, 1
    n, G = O + H, 2
    rng = np.random.default_rng(3400)
    variates = [((rng.random((G, B, R, n)) < 0.5).astype(np.float32),
                 np.clip(rng.random((S, G, B, n, R)), 1e-6, 1 - 1e-6).astype(np.float32))]
    kw = dict(dim_input=D, n_hidden_nodes=H, sample_count=R, anneal_steps=S,
              restricted=restricted)
    jm = jd.DiscQBM(sampler=_XlaReplay(variates, S), **kw)
    tm = td.DiscQBM(sampler=_TorchReplay(variates, S), device="cpu", **kw)
    d = _params(8, D, H, O, restricted)
    jm.params, tm.params = _jparams(d), td.params_from_numpy(d)
    x, y, _ = _batch(11, B, D, O, False)
    mask = np.ones(B, np.float32)
    jerr, jnll = jm.train_for_one_iteration(x, y, 0.3, mask=mask)
    terr, tnll = tm.train_for_one_iteration(x, y, 0.3, mask=mask)
    _close(float(tnll), float(jnll), rtol=0, atol=1e-5)
    _close(float(terr), float(jerr), rtol=0, atol=1e-5)
    _close_tree(tm.params, jm.params, rtol=0, atol=1e-5)
