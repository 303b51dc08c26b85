"""The plain PyTorch parallel tempering (qbmx_torch.samplers.tempering) and
the PT registry entry against qbmx.

Under host variates ``(init01, uniforms, swap_u)`` the plain version must
equal the TPU kernel's PT mode run in interpret mode
(``pt_sample_batch_pallas`` with ``debug_randoms``) EXACTLY, at the shapes
and seeds of tests/test_gibbs_pt_pallas_debug.py, and that file's mirror of
the PT semantics for ladders the packed kernel does not take.  The
generator path is held against the exact oracle with the same bar (0.08).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_gibbs_pt_pallas_debug import _pt_reference_trajectory

from qbmx.core.qubo import default_beta_range as j_default_beta_range
from qbmx.samplers.sa_pallas import pt_sample_batch_pallas
from qbmx_torch.samplers import api, pt_cuda, pt_wide_cuda, sa_torch, tempering
from qbmx_torch.samplers.exact import exact_boltzmann

torch.set_num_threads(1)
T = torch.as_tensor


def _problem(n, B, M, reads, sweeps):
    rng = np.random.default_rng(n * 100 + B * 10 + M)
    Bx = B * M
    Q = np.triu(rng.uniform(-2, 2, (B, n, n)).astype(np.float32))
    init01 = (rng.uniform(0, 1, (Bx, reads, n)) < 0.5).astype(np.float32)
    uniforms = rng.uniform(0, 1, (sweeps, Bx, n, reads)).astype(np.float32)
    swap_u = rng.uniform(0, 1, (sweeps, Bx, reads)).astype(np.float32)
    return Q, init01, uniforms, swap_u


@pytest.mark.parametrize("n,B,M,reads,sweeps", [
    (5, 2, 4, 8, 6),
    (20, 1, 8, 8, 5),
    (10, 3, 2, 8, 4),
    (6, 2, 8, 16, 1),   # one sweep: a single exchange round
    (9, 2, 8, 8, 5),    # the flat PT h8 width (K3 a rung a thread past n = 8)
    (41, 1, 8, 8, 3),   # the CDQBM (b) PT width (K3 on lanes)
])
def test_matches_packed_kernel(n, B, M, reads, sweeps):
    Q, init01, uniforms, swap_u = _problem(n, B, M, reads, sweeps)
    want = pt_sample_batch_pallas(
        jax.random.key(0), jnp.asarray(Q), reads, sweeps, num_replicas=M, beta_target=1.0,
        interpret=True, debug_randoms=tuple(map(jnp.asarray, (init01, uniforms, swap_u))))
    got = tempering.pt_sample_batch_plain(T(Q), reads, sweeps, num_replicas=M,
                                          host_variates=(T(init01), T(uniforms), T(swap_u)))
    assert tuple(got.shape) == (B, reads, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,B,M,reads,sweeps,beta", [
    (6, 2, 3, 8, 5, 1.0),   # a ladder that is not a power of two
    (7, 1, 5, 6, 4, 2.0),
    (5, 2, 1, 8, 3, 1.0),   # one rung: no exchange, the rung at beta_hot
])
def test_matches_mirror_for_any_ladder(n, B, M, reads, sweeps, beta):
    Q, init01, uniforms, swap_u = _problem(n, B, M, reads, sweeps)
    want = _pt_reference_trajectory(Q, init01, uniforms, swap_u, M, sweeps, beta)
    got = tempering.pt_sample_batch_plain(T(Q), reads, sweeps, num_replicas=M,
                                          beta_target=beta,
                                          host_variates=(T(init01), T(uniforms), T(swap_u)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("M,beta", [(8, 1.0), (2, 0.3), (1, 1.0), (5, 4.0)])
def test_ladder_betas_match_the_kernels_grid(M, beta):
    """sa_pallas.py:820-826: from min(default_hot, β/2) to β."""
    Q, _, _, _ = _problem(6, 3, M, 1, 1)
    betas, dbeta = tempering.ladder_betas(T(Q), M, beta)
    hot0, _ = j_default_beta_range(jnp.asarray(Q))
    bt = jnp.asarray(beta, jnp.float32)
    bh = jnp.minimum(hot0.astype(jnp.float32), bt * 0.5)
    t = jnp.arange(M, dtype=jnp.float32) / max(M - 1, 1)
    log_hot = jnp.log(bh)[:, None]
    want = jnp.exp(log_hot + t[None, :] * (jnp.log(bt) - log_hot))
    # rtol 1e-6: torch's and XLA's float32 exp/log differ in the last bits
    # (a few ulp here); the trajectories above still agree exactly
    np.testing.assert_allclose(betas.numpy(), np.asarray(want), rtol=1e-6)
    np.testing.assert_array_equal(dbeta[:, :-1].numpy(), (betas[:, 1:] - betas[:, :-1]).numpy())
    assert torch.all(dbeta[:, -1] == 0)
    top = torch.full((3,), beta) if M > 1 else torch.minimum(betas[:, 0], torch.tensor(beta / 2))
    assert torch.allclose(betas[:, -1], top)


def test_generator_path_matches_oracle():
    """tests/test_gibbs_pt_pallas_debug.py's problem and bar (0.08)."""
    rng = np.random.default_rng(3)
    Q = T(np.triu(rng.uniform(-1.5, 1.5, (1, 5, 5))).astype(np.float32))
    s = tempering.pt_sample_batch_plain(Q, 384, 24, num_replicas=4,
                                        generator=torch.Generator().manual_seed(0))[0]
    _, _, marg, _ = exact_boltzmann(Q[0], beta=1.0)
    assert set(s.unique().tolist()) <= {0.0, 1.0}
    assert torch.allclose(s.mean(0), marg, atol=0.08)


def test_generator_path_is_reproducible():
    Q, _, _, _ = _problem(5, 2, 3, 1, 1)
    run = lambda seed: tempering.pt_sample_batch_plain(
        T(Q), 16, 5, num_replicas=3, generator=torch.Generator().manual_seed(seed))
    assert torch.equal(run(1), run(1)) and not torch.equal(run(1), run(2))


def test_host_variates_shape_is_checked():
    Q, init01, uniforms, swap_u = _problem(5, 2, 4, 8, 3)
    with pytest.raises(ValueError, match="host_variates"):
        tempering.pt_sample_batch_plain(T(Q), 8, 3, num_replicas=4,
                                        host_variates=(T(init01), T(uniforms), T(swap_u[:2])))


def test_pt_philox_variates_layout():
    """Per-ladder streams with the rung in the counter: a ladder's draws
    depend on (seed, problem index) only; swap uniforms get their own
    counter slots; everything lies on the 2^-24 grid."""
    init01, u, sw = sa_torch.pt_philox_variates(2**40 + 3, 3, 5, 4, 6, 2)
    assert init01.shape == (15, 4, 6) and u.shape == (2, 15, 6, 4) and sw.shape == (2, 15, 4)
    assert set(np.unique(init01)) == {0.0, 1.0}
    for a in (u, sw):
        assert a.min() >= 0.0 and a.max() < 1.0 and np.all(a * 2**24 == np.round(a * 2**24))
    i2, u2, s2 = sa_torch.pt_philox_variates(2**40 + 3, 2, 5, 4, 6, 2)  # ladders 0, 1
    np.testing.assert_array_equal(i2, init01[:10])
    np.testing.assert_array_equal(u2, u[:, :10])
    np.testing.assert_array_equal(s2, sw[:, :10])
    assert not np.array_equal(u[:, 0], u[:, 1])  # rungs draw differently
    # the same words as the anneal kernels' draws of rung 0 (counter y = q)
    _, u_sa = sa_torch.philox_variates(2**40 + 3, 1, 3, 4, 6, 2)
    np.testing.assert_array_equal(u_sa[:, 0], u.reshape(2, 3, 5, 6, 4)[:, :, 0])


def test_wrapper_runs_the_plain_version_on_cpu():
    Q, init01, uniforms, swap_u = _problem(5, 2, 3, 8, 3)
    hv = (T(init01), T(uniforms), T(swap_u))
    pt_cuda.reset_launch_counts()
    pt_wide_cuda.reset_launch_counts()
    got = pt_cuda.pt_sample_batch_cuda(T(Q), 8, 3, num_replicas=3, host_variates=hv)
    want = tempering.pt_sample_batch_plain(T(Q), 8, 3, num_replicas=3, host_variates=hv)
    assert torch.equal(got, want)
    assert torch.equal(pt_wide_cuda.pt_sample_batch(T(Q), 8, 3, num_replicas=3,
                                                    host_variates=hv), want)
    assert pt_cuda.launch_counts == {"pt_heatbath": 0}
    assert pt_wide_cuda.launch_counts == {"pt_wide": 0, "pt_wide_sparse": 0, "pt_wide_global": 0,
                                          "pt_wide_global_sparse": 0}


def test_registry_pt_takes_qbmx_kwargs():
    s = api.get_sampler("PT", num_sweeps=9)
    assert isinstance(s, api.PTSampler)
    assert (s.num_sweeps, s.num_replicas, s.beta_target) == (9, 8, 1.0)
    s = api.get_sampler("pt", num_sweeps=9, num_warmup=4, num_replicas=3, beta=2.0)
    assert (s.num_sweeps, s.num_replicas, s.beta_target) == (4, 3, 2.0)
    # a structured entry (K5 takes the structured form on the card); on the
    # CPU it densifies, as qbmx does (test_structured_calls_densify)
    assert callable(s.sample_groups)


def test_structured_calls_densify():
    """``sampler_sample_groups`` on PT equals ``sample_batch`` on the
    densified batch from the same generator state."""
    rng = np.random.default_rng(4)
    Qg = T(np.triu(rng.uniform(-1, 1, (2, 5, 5))).astype(np.float32))
    h_extra = T(rng.normal(size=(2, 3, 5)).astype(np.float32))
    s = api.get_sampler("PT", num_sweeps=4, num_replicas=3)
    grp = api.sampler_sample_groups(s, torch.Generator().manual_seed(1), Qg, h_extra, 6)
    flat = s.sample_batch(torch.Generator().manual_seed(1), api.densify_groups(Qg, h_extra), 6)
    assert tuple(grp.shape) == (2, 3, 6, 5) and torch.equal(grp, flat.reshape(2, 3, 6, 5))


# -- the slice: matched-variate Disc_QBM steps with PT ------------------------


class _JaxPTReplay:
    """qbmx sampler that hands the TPU kernel's PT mode (interpret mode) the
    next set of host variates.  Like qbmx's PTSampler it has no structured
    entry, so the model's calls reach it densified."""

    jit_safe = False

    def __init__(self, variates, sweeps, M):
        self.variates, self.sweeps, self.M = list(variates), sweeps, M

    def sample_batch(self, key, Q, num_reads):
        return pt_sample_batch_pallas(
            jax.random.key(0), Q, num_reads, self.sweeps, num_replicas=self.M, interpret=True,
            debug_randoms=tuple(map(jnp.asarray, self.variates.pop(0))))


class _TorchPTReplay:
    def __init__(self, variates, sweeps, M):
        self.variates, self.sweeps, self.M = list(variates), sweeps, M

    def sample_batch(self, generator, Q, num_reads):
        return tempering.pt_sample_batch_plain(
            Q, num_reads, self.sweeps, num_replicas=self.M,
            host_variates=tuple(map(T, self.variates.pop(0))))


@pytest.mark.parametrize("one_hot,restricted,shortcut", [
    (False, False, False),
    (True, False, False),
    (False, True, True),    # linear shortcut: only the unclamped group is sampled
])
def test_three_pt_steps_and_predict_match(one_hot, restricted, shortcut):
    import qbmx.models.dqbm as jd
    import qbmx_torch.models.dqbm as td
    from test_torch_dqbm import _batch, _close, _close_tree, _jparams, _params

    D, H, B, R, S, N, M = 10, 3, 4, 8, 4, 6, 4
    O = 2 if one_hot else 1
    n_u, G = O + H, 1 if shortcut else 2
    rng = np.random.default_rng(19)
    variates = [((rng.random((p * M, R, n_u)) < 0.5).astype(np.float32),
                 rng.random((S, p * M, n_u, R)).astype(np.float32),
                 rng.random((S, p * M, R)).astype(np.float32))
                for p in [G * B] * 3 + [N]]
    kw = dict(dim_input=D, n_hidden_nodes=H, sample_count=R, anneal_steps=S,
              restricted=restricted, use_one_hot_encoding=one_hot, use_linear_shortcut=shortcut)
    jm = jd.DiscQBM(sampler=_JaxPTReplay(variates, S, M), **kw)
    tm = td.DiscQBM(sampler=_TorchPTReplay(variates, S, M), device="cpu", **kw)
    d = _params(20, D, H, O, restricted)
    jm.params, tm.params = _jparams(d), td.params_from_numpy(d)
    for step in range(3):
        x, y, _ = _batch(40 + step, B, D, O, one_hot)
        mask = np.asarray([1, 1, 1, step != 2], np.float32)
        jerr, jnll = jm.train_for_one_iteration(x, y, 0.3, mask=mask)
        terr, tnll = tm.train_for_one_iteration(x, y, 0.3, mask=mask)
        _close(float(tnll), float(jnll), rtol=0, atol=1e-5)
        _close(float(terr), float(jerr), rtol=0, atol=1e-5)
        _close_tree(tm.params, jm.params, rtol=0, atol=1e-5)
    X = np.random.default_rng(22).random((N, D)).astype(np.float32)
    (tpred, tprob), (jpred, jprob) = tm.predict_batch(X), jm.predict_batch(X)
    np.testing.assert_array_equal(tpred, jpred)
    _close(tprob, jprob, rtol=0, atol=1e-5)


def _pt_by_temperatures(Q, num_reads, num_sweeps, M, host_variates, beta_target=1.0):
    """PT as the CUDA kernel runs it: every state stays where it starts and
    carries its energy and the index ``rho`` of the rung it sits at; a swap
    exchanges two states' rungs.  The state at rung m draws rung m's
    variates (slot b·M + m) at ``betas[m]``.  Returns the target rung's
    states and the final rungs (B, M, R)."""
    from qbmx_torch.core.qubo import split_qubo

    B, n = Q.shape[0], Q.shape[-1]
    R = num_reads
    init01, uniforms, swap_u = host_variates
    h, J = split_qubo(Q)
    h, J = h[:, None], J[:, None]
    betas, dbeta = tempering.ladder_betas(Q, M, beta_target)
    s = init01.reshape(B, M, R, n).clone()  # by state; state w starts at rung w
    rungs = torch.arange(M)[None, :, None].expand(B, M, R)
    rho = rungs.clone()
    for t in range(num_sweeps):
        u = uniforms[t].reshape(B, M, n, R)
        u_by_state = torch.gather(u, 1, rho[:, :, None, :].expand(B, M, n, R))
        beta_by_state = torch.gather(betas[:, :, None].expand(B, M, R), 1, rho)
        thresh = (torch.log(1 - u_by_state) - torch.log(u_by_state)) / beta_by_state[:, :, None]
        for i in range(n):
            field = h[..., i, None] + torch.matmul(s, J[..., i, :, None])[..., 0]
            s[..., i] = (field < thresh[..., i, :]).to(s.dtype)
        if t % 2 >= M - 1:
            continue
        E = (s @ h[..., None])[..., 0] + 0.5 * ((s @ J) * s).sum(-1)  # by state
        at = torch.empty_like(rho).scatter_(1, rho, rungs)
        E_rung = torch.gather(E, 1, at)  # at[:, m]: the state at rung m
        lo = torch.arange(t % 2, M - 1, 2)
        usw = swap_u[t].reshape(B, M, R)[:, lo]
        swap = dbeta[:, lo, None] * (E_rung[:, lo] - E_rung[:, lo + 1]) < -torch.log(usw)
        new_at = at.clone()
        new_at[:, lo] = torch.where(swap, at[:, lo + 1], at[:, lo])
        new_at[:, lo + 1] = torch.where(swap, at[:, lo], at[:, lo + 1])
        rho = torch.empty_like(rho).scatter_(1, new_at, rungs)
    target = rho.eq(M - 1).to(torch.int64).argmax(1, keepdim=True)  # (B, 1, R): its state
    out = torch.gather(s, 1, target[..., None].expand(B, 1, R, n))[:, 0]
    return out, rho


@pytest.mark.parametrize("n,B,M,reads,sweeps", [
    (5, 2, 4, 8, 6),
    (6, 3, 8, 16, 12),
    (7, 1, 5, 6, 9),    # a ladder that is not a power of two
    (10, 2, 2, 8, 4),
    (5, 2, 1, 8, 3),    # one rung: no exchange
])
def test_swapping_temperatures_equals_swapping_states(n, B, M, reads, sweeps):
    """The CUDA kernel's design, emulated here: exchanging the rungs of two
    states gives exactly the plain version's samples, which exchanges the
    states, on the same host variates (slot b·M + m keyed by the rung)."""
    Q, init01, uniforms, swap_u = _problem(n, B, M, reads, sweeps)
    hv = (T(init01), T(uniforms), T(swap_u))
    got, rho = _pt_by_temperatures(T(Q), reads, sweeps, M, hv)
    want = tempering.pt_sample_batch_plain(T(Q), reads, sweeps, num_replicas=M, host_variates=hv)
    assert torch.equal(got, want)
    assert torch.equal(rho.sort(1).values, torch.arange(M)[None, :, None].expand_as(rho))
    if M > 2:  # the emulation did move states between rungs
        assert not torch.equal(rho, torch.arange(M)[None, :, None].expand_as(rho))


def _ladder_exchange(e, rho, inv, M, L, t, dbeta, usw):
    """``pt_heatbath.cuh::ladder_exchange<L>`` on one warp, lane by lane:
    the warp's 32 lanes hold ⌊32/(M·L)⌋ ladders of M groups of L lanes
    (RUNG: L = 1), and lanes past them shadow a ladder.  ``e``, ``rho``,
    ``inv`` (32,) by lane; ``dbeta`` (M,); ``usw`` (ladders, M) the swap
    uniforms by ladder and lower rung.  Returns the new ``rho``, ``inv``."""
    lane = np.arange(32)
    sub, q, pos = lane % L, lane // L // M, lane // L % M
    base, ladders = q * M, 32 // (M * L)
    shfl = lambda x, src: x[src % 32]  # __shfl_sync: the source lane within the warp
    down = lambda x, d: np.where(lane + d < 32, x[np.minimum(lane + d, 31)], x)
    up = lambda x, d: np.where(lane >= d, x[np.maximum(lane - d, 0)], x)
    e_rung = shfl(e, (base + inv) * L + sub)
    e_next = down(e_rung, L)
    swap = np.zeros(32, bool)
    for k in range(32):
        if q[k] < ladders and pos[k] < M - 1 and pos[k] % 2 == t % 2:
            swap[k] = (dbeta[pos[k]] * (e_rung[k] - e_next[k])
                       < -np.log(usw[q[k], pos[k]], dtype=np.float32))
    inv_next, inv_prev = down(inv, L), up(inv, L)
    new_inv = inv.copy()
    for k in range(32):
        if swap[k]:
            new_inv[k] = inv_next[k]
        elif pos[k] > 0 and swap[k - L]:
            new_inv[k] = inv_prev[k]
    new_rho = rho.copy()
    for k in range(32):
        at = ((base[k] + rho[k]) * L + sub[k]) & 31
        if rho[k] < M - 1 and swap[at]:
            new_rho[k] += 1
        elif rho[k] > 0 and swap[(at + 32 - L) & 31]:
            new_rho[k] -= 1
    return new_rho, new_inv


@pytest.mark.parametrize("M,L", [(8, 1), (5, 1), (32, 1), (3, 1), (8, 4), (4, 8), (2, 16),
                                 (3, 4), (3, 8), (6, 4), (2, 4)])
def test_ladder_exchange_at_a_stride_of_lanes_equals_swapping_states(M, L):
    """K3's exchange for ladders within a warp (a rung a thread, L = 1, and
    a rung on L lanes, M·L ≤ 32), emulated lane by lane: the states' rungs
    move as the plain version's states do (``_pt_by_temperatures``'s
    exchange of the states at rungs m and m + 1), every lane of a group
    agreeing, over 40 sweeps of random energies, wherever the warp's
    ladders stop."""
    rng = np.random.default_rng(M * 100 + L)
    lane = np.arange(32)
    pos, q = lane // L % M, lane // L // M
    ladders = 32 // (M * L)
    rho, inv = pos.copy(), pos.copy()
    dbeta = rng.uniform(0.05, 0.5, M).astype(np.float32)
    at = np.tile(np.arange(M), (ladders, 1))  # at[q, m]: the position whose state sits at rung m
    moved = False
    for t in range(40):
        E = rng.normal(0, 3, (ladders + 1, M)).astype(np.float32)  # by ladder (and shadow), position
        usw = rng.uniform(1e-6, 1, (ladders, M)).astype(np.float32)
        e = E[np.minimum(q, ladders), pos]
        rho, inv = _ladder_exchange(e, rho, inv, M, L, t, dbeta, usw)
        for w in range(ladders):  # the plain exchange of this sweep's links
            for lo in range(t % 2, M - 1, 2):
                a, b = at[w, lo], at[w, lo + 1]
                if dbeta[lo] * (E[w, a] - E[w, b]) < -np.log(usw[w, lo], dtype=np.float32):
                    at[w, lo], at[w, lo + 1] = b, a
                    moved = True
        for k in range(ladders * M * L):  # the live lanes: rho and inv as the plain rungs
            assert at[q[k], rho[k]] == pos[k] and inv[k] == at[q[k], pos[k]]
    assert moved or M == 1


# -- the structured entry (K5's form) on the CPU -------------------------------


@pytest.mark.parametrize("G,B,n,M,R,S", [(2, 3, 7, 4, 8, 5), (1, 2, 12, 3, 6, 4),
                                         (3, 1, 5, 1, 8, 3)])
def test_structured_entry_plain_route_equals_the_densified_batch(G, B, n, M, R, S):
    """``pt_wide_cuda.pt_sample_groups`` on CPU tensors is the plain version
    on ``densify_groups``, exactly, under the same host variates in slot
    order (g·B + b)·M + m."""
    rng = np.random.default_rng(G * 100 + n)
    Qg = T(np.triu(rng.uniform(-1, 1, (G, n, n))).astype(np.float32))
    h_extra = T(rng.normal(size=(G, B, n)).astype(np.float32))
    hv = (T((rng.random((G * B * M, R, n)) < 0.5).astype(np.float32)),
          T(rng.random((S, G * B * M, n, R)).astype(np.float32)),
          T(rng.random((S, G * B * M, R)).astype(np.float32)))
    got = pt_wide_cuda.pt_sample_groups(Qg, h_extra, R, S, num_replicas=M, host_variates=hv)
    want = tempering.pt_sample_batch_plain(api.densify_groups(Qg, h_extra), R, S,
                                           num_replicas=M, host_variates=hv)
    assert got.shape == (G, B, R, n) and torch.equal(got, want.reshape(G, B, R, n))


def test_structured_form_is_the_densified_batch_split():
    """K5's inputs: J_g and h = diag(Q_g) + h_extra are the split of the
    densified batch, and the ladders are ``ladder_betas`` of it, bit for
    bit, at CDQBM (a)'s width."""
    from qbmx_torch.core.qubo import split_qubo

    rng = np.random.default_rng(5)
    G, B, n, M = 2, 3, 717, 8
    Qg = T(np.triu(rng.uniform(-1, 1, (G, n, n))).astype(np.float32))
    h_extra = T(rng.normal(size=(G, B, n)).astype(np.float32))
    J, h, betas, dbeta = pt_wide_cuda.structured_form(Qg, h_extra, M, 1.0)
    Qd = api.densify_groups(Qg, h_extra)
    hd, Jd = split_qubo(Qd)
    assert torch.equal(h.reshape(G * B, n), hd)
    assert torch.equal(J[:, None].expand(G, B, n, n).reshape(G * B, n, n), Jd)
    want_b, want_d = tempering.ladder_betas(Qd, M, 1.0)
    assert torch.equal(betas, want_b) and torch.equal(dbeta, want_d)
    assert betas.shape == (G * B, M) and betas.is_contiguous() and J.is_contiguous()


def test_pt_philox_variates_k5_layout():
    """K5's draws: K3's counter layout with the rung shifted 10 bits (n up
    to 4096): rung 0's variable draws are K3's, the others' and the swap
    draws are not."""
    a = sa_torch.pt_philox_variates(2**33 + 5, 2, 3, 4, 6, 2)
    b = sa_torch.pt_philox_variates(2**33 + 5, 2, 3, 4, 6, 2, var_shift=pt_wide_cuda.VAR_SHIFT)
    rung0 = lambda arr, axis: np.take(arr.reshape(arr.shape[:axis] + (2, 3) + arr.shape[axis + 1:]),
                                      0, axis=axis + 1)
    np.testing.assert_array_equal(rung0(a[0], 0), rung0(b[0], 0))
    np.testing.assert_array_equal(rung0(a[1], 1), rung0(b[1], 1))
    assert not np.array_equal(a[1], b[1]) and not np.array_equal(a[2], b[2])
    # the swap word of rung m at counter (read, ((m // 4) << 10) | 0x3FF, sweep)
    key = (np.uint64(5), np.arange(2, dtype=np.uint64)[:, None])
    words = sa_torch.philox4x32_10((np.arange(4, dtype=np.uint64), np.uint64(0x3FF), np.uint64(1),
                                    np.uint64(2)), key)
    np.testing.assert_array_equal(b[2][1].reshape(2, 3, 4)[:, 2],
                                  ((words[2] >> np.uint64(8)).astype(np.float32)
                                   * np.float32(2.0**-24)))
