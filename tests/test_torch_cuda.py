"""The CUDA kernels on the card -- Metropolis (qbmx_torch/csrc/sa_metropolis.cu),
heat-bath (sa_heatbath.cu, each update width), the wide anneal
(anneal_wide.cu, both rules, for couplings beyond shared memory) and
parallel tempering (pt_heatbath.cu, and pt_wide.cu for couplings beyond
shared memory) -- at small shapes, each layout of each
kernel forced as well as chosen: each against its plain PyTorch version
under host variates and on its own Philox draws written out, its Philox
streams against the exact oracle, the launch counters, the incremental
fields of K2, K4 and K5 (and K5's energies), K5's two paths (J_g's row
lists in shared memory, or its tiles streamed) against each other bit for
bit, its ladders over a thread block cluster, the global-field layouts
(K4's, and K5's global path) against the shared ones bit for bit and
against plain past n = 3368 and past a cluster, and the wrappers' routes
and refusals.
The RBM (no kernel of its own: batched matmuls) on the card against the
CPU.  ``chip_smoke.py`` runs the same checks at the main path's shapes.

Run on a machine with a CUDA GPU:  python -m pytest --noconftest tests/test_torch_cuda.py
(``--noconftest``: ``tests/conftest.py`` imports jax, which the port does not
need).  Elsewhere every test skips.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest
import torch

from qbmx_torch.core.qubo import default_beta_range, random_qubo_batch, split_qubo
from qbmx_torch.core.rng import draw_seed
from qbmx_torch.models.cdqbm import cdqbm_a_qubos
from qbmx_torch.samplers import (api, gibbs, gibbs_cuda, kernel_call, pt_cuda, pt_wide_cuda,
                                 sa_cuda, sa_torch, tempering, wide_cuda)
from qbmx_torch.samplers.exact import exact_boltzmann

pytestmark = pytest.mark.cuda
MAX_DIFF_FRAC = 0.01  # chains that may end elsewhere: a near-tie flip from a
# field summed or a log rounded differently diverges that one chain


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain version in full float32
    return torch.device("cuda")


def _variates(rng, lead, n, R, S, dev):
    init01 = (rng.random(lead + (R, n)) < 0.5).astype(np.float32)
    u = np.clip(rng.random((S,) + lead + (n, R)), 1e-6, 1 - 1e-6).astype(np.float32)
    return torch.as_tensor(init01, device=dev), torch.as_tensor(u, device=dev)


def _differ(a, b):
    n = a.shape[-1]
    return (a != b).reshape(-1, n).any(dim=1).float().mean().item()


@pytest.mark.parametrize("G,B,n,R,S", [(2, 3, 5, 7, 4), (1, 2, 41, 33, 5),
                                       (3, 2, 11, 130, 6), (1, 1, 200, 4, 2)])
def test_groups_kernel_matches_plain(dev, G, B, n, R, S):
    rng = np.random.default_rng(n)
    Q = random_qubo_batch(rng, G, n).to(dev)
    h_extra = torch.as_tensor(rng.normal(size=(G, B, n)).astype(np.float32), device=dev)
    hv = _variates(rng, (G, B), n, R, S, dev)
    sa_cuda.reset_launch_counts()
    got = sa_cuda.sa_sample_groups_cuda(Q, h_extra, R, S, host_variates=hv)
    torch.cuda.synchronize()
    assert sa_cuda.launch_counts["sa_metropolis"] == 1
    want = sa_torch.sa_sample_groups_plain(Q, h_extra, R, S, host_variates=hv)
    assert got.shape == (G, B, R, n) and got.device.type == "cuda"
    assert _differ(got, want) <= MAX_DIFF_FRAC


@pytest.mark.parametrize("B,n,R,S", [(3, 6, 16, 8), (2, 41, 20, 6), (2, 6, 8, 1)])
def test_batch_kernel_matches_plain(dev, B, n, R, S):
    rng = np.random.default_rng(100 + n)
    Q = random_qubo_batch(rng, B, n, scale=2.0).to(dev)
    hv = _variates(rng, (B,), n, R, S, dev)
    got = sa_cuda.sa_sample_batch_cuda(Q, R, S, host_variates=hv)
    want = sa_torch.sa_sample_batch_plain(Q, R, S, host_variates=hv)
    assert got.shape == (B, R, n)
    assert _differ(got, want) <= MAX_DIFF_FRAC


@pytest.mark.parametrize("G,B,n,R,S", [(2, 3, 6, 40, 7), (1, 2, 41, 33, 3)])
def test_philox_path_matches_plain_on_its_variates(dev, G, B, n, R, S):
    """Generator mode: the kernel's own Philox draws, written out on the
    host (``sa_torch.philox_variates``), drive the plain version to the
    kernel's samples -- for the structured and the dense entry."""
    rng = np.random.default_rng(n)
    Q = random_qubo_batch(rng, G, n).to(dev)
    h_extra = torch.as_tensor(rng.normal(size=(G, B, n)).astype(np.float32), device=dev)
    seed = draw_seed(torch.Generator().manual_seed(11))
    got = sa_cuda.sa_sample_groups_cuda(Q, h_extra, R, S,
                                        generator=torch.Generator().manual_seed(11))
    hv = tuple(torch.as_tensor(a, device=dev) for a in sa_torch.philox_variates(seed, G, B, R, n, S))
    assert _differ(got, sa_torch.sa_sample_groups_plain(Q, h_extra, R, S, host_variates=hv)) \
        <= MAX_DIFF_FRAC
    got = sa_cuda.sa_sample_batch_cuda(Q, R, S, generator=torch.Generator().manual_seed(11))
    init01, u = sa_torch.philox_variates(seed, G, 1, R, n, S)
    hv = (torch.as_tensor(init01[:, 0], device=dev), torch.as_tensor(u[:, :, 0], device=dev))
    assert _differ(got, sa_torch.sa_sample_batch_plain(Q, R, S, host_variates=hv)) <= MAX_DIFF_FRAC


@pytest.mark.parametrize("n", [2, 5, 8])
def test_philox_path_matches_oracle(dev, n):
    """tests/test_samplers.py's problems and bound."""
    Q = random_qubo_batch(np.random.default_rng(0), 1, n, scale=0.5).to(dev)
    s = sa_cuda.sa_sample_batch_cuda(Q, 512, 200, generator=torch.Generator().manual_seed(n))
    _, cold = default_beta_range(Q[0])
    _, _, marg, _ = exact_boltzmann(Q[0], beta=float(cold))
    assert set(s.unique().tolist()) <= {0.0, 1.0}
    assert torch.allclose(s[0].mean(0), marg, atol=0.12)


def test_philox_streams_are_per_problem(dev):
    # weak couplings and a mild schedule keep the samples diffuse, so equal
    # samples can only come from equal streams
    rng = np.random.default_rng(1)
    Qa = random_qubo_batch(rng, 3, 6, scale=0.2).to(dev)
    Qb = Qa.clone()
    Qb[1:] = random_qubo_batch(rng, 2, 6, scale=0.2).to(dev)
    zeros = torch.zeros((3, 1, 6), device=dev)
    run = lambda Q, seed: sa_cuda.sa_sample_groups_cuda(
        Q, zeros, 64, 50, generator=torch.Generator().manual_seed(seed),
        beta_hot=0.5, beta_cold=1.0)[:, 0]
    a, b, c = run(Qa, 7), run(Qb, 7), run(Qa, 8)
    assert len({tuple(r) for r in a[0].tolist()}) > 5
    assert torch.equal(a[0], b[0]) and torch.equal(a, run(Qa, 7))
    assert not torch.equal(a[0], c[0])
    dense = sa_cuda.sa_sample_batch_cuda(Qa, 64, 50, generator=torch.Generator().manual_seed(7))
    assert dense.shape == (3, 64, 6)


def test_wrappers_refuse_what_the_kernel_does_not_take(dev):
    Q = torch.zeros((1, 4, 4), device=dev)
    h = torch.zeros((1, 2, 4), device=dev)
    init01, u = _variates(np.random.default_rng(2), (1, 2), 4, 3, 2, dev)
    with pytest.raises(ValueError, match="uniforms"):
        sa_cuda.sa_sample_groups_cuda(Q, h, 3, 2, host_variates=(init01, u.double()))
    with pytest.raises(ValueError, match="init01"):
        sa_cuda.sa_sample_groups_cuda(Q, h, 3, 2, host_variates=(init01.transpose(2, 3), u))
    n = wide_cuda_max_n() + 1  # beyond K1 and K4's shared layout: its global-field layout
    wide_cuda.reset_launch_counts()
    out = sa_cuda.sa_sample_batch_cuda(torch.zeros((1, n, n), device=dev), 2, 2)
    torch.cuda.synchronize()
    # an all-zero J_g: the global-field layout's sparse pass
    assert out.shape == (1, 2, n) and wide_cuda.launch_counts == {
        "anneal_wide": 0, "anneal_wide_sparse": 0, "anneal_wide_global": 0,
        "anneal_wide_global_sparse": 1}


def test_model_steps_launch_the_kernel(dev):
    from qbmx_torch.models.dqbm import DiscQBM

    m = DiscQBM(dim_input=16, n_hidden_nodes=3, sample_count=32, anneal_steps=20,
                restricted=False, device=dev)
    x = np.random.default_rng(3).random((40, 16)).astype(np.float32)
    y = np.arange(40) % 2
    sa_cuda.reset_launch_counts()
    nlls, _ = m.train_epoch(x, y, 10, 0.3)
    preds, probs = m.predict_batch(x)
    assert sa_cuda.launch_counts["sa_metropolis"] == 5  # 4 steps + 1 prediction
    assert np.isfinite(nlls).all() and preds.shape == (40,) and probs.shape == (40, 2)


# -- the heat-bath kernel (qbmx_torch/csrc/sa_heatbath.cu) --------------------

WIDTHS = {1: dict(), 2: dict(pair=True), 4: dict(quad=True)}


@pytest.mark.parametrize("width", [1, 2, 4])
@pytest.mark.parametrize("G,B,n,R,S", [(2, 3, 6, 40, 7), (1, 2, 41, 33, 5),
                                       (3, 2, 11, 130, 6), (1, 1, 199, 4, 2),
                                       (2, 3, 41, 100, 30)])  # the CDQBM default call
def test_heatbath_groups_kernel_matches_plain(dev, width, G, B, n, R, S):
    rng = np.random.default_rng(n + width)
    Q = random_qubo_batch(rng, G, n).to(dev)
    h_extra = torch.as_tensor(rng.normal(size=(G, B, n)).astype(np.float32), device=dev)
    hv = _variates(rng, (G, B), n, R, S, dev)
    gibbs_cuda.reset_launch_counts()
    got = gibbs_cuda.gibbs_sample_groups_cuda(Q, h_extra, R, S, beta=1.5, host_variates=hv,
                                              **WIDTHS[width])
    torch.cuda.synchronize()
    assert gibbs_cuda.launch_counts["sa_heatbath"] == 1
    want = gibbs.gibbs_sample_groups_plain(Q, h_extra, R, S, beta=1.5, host_variates=hv,
                                           **WIDTHS[width])
    assert got.shape == (G, B, R, n) and got.device.type == "cuda"
    assert _differ(got, want) <= MAX_DIFF_FRAC


@pytest.mark.parametrize("width", [1, 2, 4])
@pytest.mark.parametrize("B,n,R,S", [(3, 7, 16, 8), (2, 41, 20, 6), (2, 6, 8, 1)])
def test_heatbath_batch_kernel_matches_plain(dev, width, B, n, R, S):
    rng = np.random.default_rng(200 + n + width)
    Q = random_qubo_batch(rng, B, n, scale=2.0).to(dev)
    hv = _variates(rng, (B,), n, R, S, dev)
    got = gibbs_cuda.gibbs_sample_batch_cuda(Q, R, S, host_variates=hv, **WIDTHS[width])
    want = gibbs.gibbs_sample_batch_plain(Q, R, S, host_variates=hv, **WIDTHS[width])
    assert got.shape == (B, R, n)
    assert _differ(got, want) <= MAX_DIFF_FRAC


@pytest.mark.parametrize("width", [1, 2, 4])
def test_heatbath_philox_path_matches_plain_on_its_variates(dev, width):
    """The kernel's draws are those of the Metropolis kernel's streams."""
    G, B, n, R, S = 2, 3, 7, 40, 6
    rng = np.random.default_rng(width)
    Q = random_qubo_batch(rng, G, n).to(dev)
    h_extra = torch.as_tensor(rng.normal(size=(G, B, n)).astype(np.float32), device=dev)
    seed = draw_seed(torch.Generator().manual_seed(12))
    got = gibbs_cuda.gibbs_sample_groups_cuda(Q, h_extra, R, S, **WIDTHS[width],
                                              generator=torch.Generator().manual_seed(12))
    hv = tuple(torch.as_tensor(a, device=dev) for a in sa_torch.philox_variates(seed, G, B, R, n, S))
    want = gibbs.gibbs_sample_groups_plain(Q, h_extra, R, S, host_variates=hv, **WIDTHS[width])
    assert _differ(got, want) <= MAX_DIFF_FRAC


@pytest.mark.parametrize("width", [1, 2, 4])
def test_heatbath_philox_path_matches_oracle(dev, width):
    """tests/test_gibbs_pt_pallas_debug.py's problems and bars."""
    seed, reads, sweeps, atol = (9, 384, 48, 0.08) if width == 1 else (11, 2048, 64, 0.05)
    rng = np.random.default_rng(seed)
    Q = torch.as_tensor(np.triu(rng.uniform(-1, 1, (1, 6, 6))).astype(np.float32), device=dev)
    s = gibbs_cuda.gibbs_sample_batch_cuda(Q, reads, sweeps, **WIDTHS[width],
                                           generator=torch.Generator().manual_seed(4))[0]
    _, _, marg, pair_m = exact_boltzmann(Q[0], beta=1.0)
    assert set(s.unique().tolist()) <= {0.0, 1.0}
    assert torch.allclose(s.mean(0), marg, atol=atol)
    if width > 1:
        assert torch.allclose(s.T @ s / reads, pair_m, atol=0.07)


def test_heatbath_streams_are_per_problem(dev):
    rng = np.random.default_rng(1)
    Qa = random_qubo_batch(rng, 3, 6, scale=0.2).to(dev)
    Qb = Qa.clone()
    Qb[1:] = random_qubo_batch(rng, 2, 6, scale=0.2).to(dev)
    run = lambda Q, seed: gibbs_cuda.gibbs_sample_batch_cuda(
        Q, 64, 20, pair=True, beta=0.5, generator=torch.Generator().manual_seed(seed))
    a, b, c = run(Qa, 7), run(Qb, 7), run(Qa, 8)
    assert len({tuple(r) for r in a[0].tolist()}) > 5
    assert torch.equal(a[0], b[0]) and torch.equal(a, run(Qa, 7))
    assert not torch.equal(a[0], c[0])


def test_heatbath_wrappers_refuse_what_the_kernel_does_not_take(dev):
    Q = torch.zeros((1, 4, 4), device=dev)
    h = torch.zeros((1, 2, 4), device=dev)
    init01, u = _variates(np.random.default_rng(2), (1, 2), 4, 3, 2, dev)
    with pytest.raises(ValueError, match="uniforms"):
        gibbs_cuda.gibbs_sample_groups_cuda(Q, h, 3, 2, host_variates=(init01, u[..., :2]))
    with pytest.raises(ValueError, match="init01"):
        gibbs_cuda.gibbs_sample_groups_cuda(Q, h, 3, 2, host_variates=(init01.transpose(2, 3), u))
    n = wide_cuda_max_n() + 1  # beyond K2 and K4's shared layout: its global-field layout
    wide_cuda.reset_launch_counts()
    out = gibbs_cuda.gibbs_sample_batch_cuda(torch.zeros((1, n, n), device=dev), 2, 2, quad=True)
    torch.cuda.synchronize()
    # an all-zero J_g: the global-field layout's sparse pass
    assert out.shape == (1, 2, n) and wide_cuda.launch_counts == {
        "anneal_wide": 0, "anneal_wide_sparse": 0, "anneal_wide_global": 0,
        "anneal_wide_global_sparse": 1}


# -- the wide anneal kernel (qbmx_torch/csrc/anneal_wide.cu) -------------------

RULES = {"metropolis": None, "single": dict(), "pair": dict(pair=True), "quad": dict(quad=True)}


def wide_cuda_max_n() -> int:
    from qbmx_torch._build import load_kernels

    return load_kernels().qbmx_anneal_wide_max_n()


def _structured(rng, G, B, n, dev):
    Q = random_qubo_batch(rng, G, n).to(dev)
    return Q, torch.as_tensor(rng.normal(size=(G, B, n)).astype(np.float32), device=dev)


def _kernel_groups(rule, Q, h_extra, R, S, **kw):
    """The structured wrapper of ``rule`` (K1/K2's, routed to K4 when wide)."""
    if rule == "metropolis":
        return sa_cuda.sa_sample_groups_cuda(Q, h_extra, R, S, **kw)
    return gibbs_cuda.gibbs_sample_groups_cuda(Q, h_extra, R, S, beta=1.5, **RULES[rule], **kw)


def _plain_groups(rule, Q, h_extra, R, S, hv):
    """Its plain version on host variates ``hv``."""
    if rule == "metropolis":
        return sa_torch.sa_sample_groups_plain(Q, h_extra, R, S, host_variates=hv)
    return gibbs.gibbs_sample_groups_plain(Q, h_extra, R, S, beta=1.5, **RULES[rule],
                                           host_variates=hv)


def test_shared_memory_bounds_match_the_boundary(dev):
    """K1, K2 and K3 take exactly the widths ``kernel_call.fits_shared``
    admits (n ≤ 241); K4 takes every width up to at least 2048."""
    from qbmx_torch._build import load_kernels

    lib = load_kernels()
    last = max(n for n in range(1, 300) if kernel_call.fits_shared(n))
    assert last == 241
    assert lib.qbmx_sa_metropolis_max_n() == lib.qbmx_sa_heatbath_max_n() == last
    assert lib.qbmx_pt_heatbath_max_n() == last
    assert wide_cuda_max_n() >= 2048


@pytest.mark.parametrize("rule", list(RULES))
@pytest.mark.parametrize("G,B,n,R,S", [(2, 2, 300, 40, 3), (1, 3, 717, 20, 2),
                                       (2, 1, 243, 70, 2)])
def test_wide_kernel_matches_plain(dev, rule, G, B, n, R, S):
    """Above n = 241 the wrappers launch K4, never K1 or K2."""
    rng = np.random.default_rng(n + len(rule))
    Q, h_extra = _structured(rng, G, B, n, dev)
    hv = _variates(rng, (G, B), n, R, S, dev)
    for mod in (sa_cuda, gibbs_cuda, wide_cuda):
        mod.reset_launch_counts()
    got = _kernel_groups(rule, Q, h_extra, R, S, host_variates=hv)
    torch.cuda.synchronize()
    assert wide_cuda.launch_counts["anneal_wide"] == 1
    assert sa_cuda.launch_counts["sa_metropolis"] == gibbs_cuda.launch_counts["sa_heatbath"] == 0
    assert got.shape == (G, B, R, n) and got.device.type == "cuda"
    assert _differ(got, _plain_groups(rule, Q, h_extra, R, S, hv)) <= MAX_DIFF_FRAC


@pytest.mark.parametrize("rule", list(RULES))
def test_wide_dense_entry_matches_plain(dev, rule):
    B, n, R, S = 3, 260, 24, 2
    rng = np.random.default_rng(7 + len(rule))
    Q = random_qubo_batch(rng, B, n, scale=2.0).to(dev)
    hv = _variates(rng, (B,), n, R, S, dev)
    wide_cuda.reset_launch_counts()
    if rule == "metropolis":
        got = sa_cuda.sa_sample_batch_cuda(Q, R, S, host_variates=hv)
        want = sa_torch.sa_sample_batch_plain(Q, R, S, host_variates=hv)
    else:
        got = gibbs_cuda.gibbs_sample_batch_cuda(Q, R, S, host_variates=hv, **RULES[rule])
        want = gibbs.gibbs_sample_batch_plain(Q, R, S, host_variates=hv, **RULES[rule])
    assert wide_cuda.launch_counts["anneal_wide"] == 1
    assert got.shape == (B, R, n)
    assert _differ(got, want) <= MAX_DIFF_FRAC


@pytest.mark.parametrize("rule", list(RULES))
def test_wide_philox_path_matches_plain_on_its_variates(dev, rule):
    """K4 draws the streams of K1 and K2."""
    G, B, n, R, S = 2, 2, 250, 16, 3
    rng = np.random.default_rng(21)
    Q, h_extra = _structured(rng, G, B, n, dev)
    seed = draw_seed(torch.Generator().manual_seed(14))
    got = _kernel_groups(rule, Q, h_extra, R, S, generator=torch.Generator().manual_seed(14))
    hv = tuple(torch.as_tensor(a, device=dev) for a in sa_torch.philox_variates(seed, G, B, R, n, S))
    assert _differ(got, _plain_groups(rule, Q, h_extra, R, S, hv)) <= MAX_DIFF_FRAC


def _forced_wide(Q, R, S, rule, generator=None, host_variates=None, beta=1.0, field_pass=None):
    """K4 launched directly on a dense batch, past the routing (``field_pass``
    forces a path)."""
    h, J = split_qubo(Q)
    h = h[:, None].contiguous()
    if rule == wide_cuda.METROPOLIS:
        hot, logr = sa_torch.schedule_params(h, J[:, None], S)
    else:
        hot, logr = gibbs.heat_bath_schedule(h, J[:, None], S, beta)
    return wide_cuda.launch(J.contiguous(), h, hot, logr, R, S, rule, generator=generator,
                            host_variates=host_variates, field_pass=field_pass)[:, 0]


@pytest.mark.parametrize("n", [2, 5, 8])
def test_forced_wide_kernel_matches_oracle(dev, n):
    """K4 at narrow widths, past the routing: the oracle bounds of K1
    (Metropolis, cold beta) and K2 (pair heat-bath, beta 1)."""
    Q = random_qubo_batch(np.random.default_rng(0), 1, n, scale=0.5).to(dev)
    s = _forced_wide(Q, 512, 200, wide_cuda.METROPOLIS, torch.Generator().manual_seed(n))
    _, cold = default_beta_range(Q[0])
    _, _, marg, _ = exact_boltzmann(Q[0], beta=float(cold))
    assert set(s.unique().tolist()) <= {0.0, 1.0}
    assert torch.allclose(s[0].mean(0), marg, atol=0.12)
    Q = torch.as_tensor(np.triu(np.random.default_rng(11).uniform(-1, 1, (1, n, n)))
                        .astype(np.float32), device=dev)
    s = _forced_wide(Q, 2048, 64, wide_cuda.PAIR, torch.Generator().manual_seed(4))[0]
    _, _, marg, pair_m = exact_boltzmann(Q[0], beta=1.0)
    assert torch.allclose(s.mean(0), marg, atol=0.05)
    assert torch.allclose(s.T @ s / 2048, pair_m, atol=0.07)


@pytest.mark.parametrize("rule", [0, 1, 2, 4])
def test_forced_wide_kernel_matches_plain_at_narrow_width(dev, rule):
    """n = 41, where K1 and K2 serve the wrappers: K4 forced gives the plain
    version's samples too."""
    B, n, R, S = 2, 41, 33, 5
    rng = np.random.default_rng(40 + rule)
    Q = random_qubo_batch(rng, B, n, scale=2.0).to(dev)
    init01, u = _variates(rng, (B,), n, R, S, dev)
    got = _forced_wide(Q, R, S, rule, host_variates=(init01[:, None], u[:, :, None]))
    if rule == wide_cuda.METROPOLIS:
        want = sa_torch.sa_sample_batch_plain(Q, R, S, host_variates=(init01, u))
    else:
        want = gibbs.gibbs_sample_batch_plain(Q, R, S, host_variates=(init01, u), pair=rule == 2,
                                              quad=rule == 4)
    assert _differ(got, want) <= MAX_DIFF_FRAC


def test_wide_launch_refuses_an_unknown_rule(dev):
    J, h, hot = (torch.zeros(s, device=dev) for s in ((1, 4, 4), (1, 1, 4), (1, 1)))
    with pytest.raises(ValueError, match="rule"):
        wide_cuda.launch(J, h, hot, hot, 2, 2, 3)


# -- the tempering kernel (qbmx_torch/csrc/pt_heatbath.cu) --------------------


def _pt_variates(rng, B, M, n, R, S, dev):
    init01 = (rng.random((B * M, R, n)) < 0.5).astype(np.float32)
    u = np.clip(rng.random((S, B * M, n, R)), 1e-6, 1 - 1e-6).astype(np.float32)
    sw = np.clip(rng.random((S, B * M, R)), 1e-6, 1 - 1e-6).astype(np.float32)
    return tuple(torch.as_tensor(a, device=dev) for a in (init01, u, sw))


@pytest.mark.parametrize("B,n,M,R,S", [(3, 6, 8, 200, 20), (2, 41, 4, 33, 5),
                                       (2, 5, 3, 130, 6), (1, 7, 1, 16, 3), (1, 30, 60, 8, 2),
                                       (2, 100, 32, 8, 4),  # M·n = 3,200
                                       (2, 241, 8, 6, 3), (1, 241, 15, 3, 2),  # n = 241
                                       (1, 64, 33, 6, 3),  # two rungs a warp
                                       (3, 8, 32, 20, 6)])  # a ladder a warp's lanes
def test_pt_kernel_matches_plain(dev, B, n, M, R, S):
    rng = np.random.default_rng(300 + n + M)
    Q = random_qubo_batch(rng, B, n).to(dev)
    hv = _pt_variates(rng, B, M, n, R, S, dev)
    pt_cuda.reset_launch_counts()
    got = pt_cuda.pt_sample_batch_cuda(Q, R, S, num_replicas=M, host_variates=hv)
    torch.cuda.synchronize()
    assert pt_cuda.launch_counts["pt_heatbath"] == 1
    want = tempering.pt_sample_batch_plain(Q, R, S, num_replicas=M, host_variates=hv)
    assert got.shape == (B, R, n) and got.device.type == "cuda"
    assert _differ(got, want) <= MAX_DIFF_FRAC


def test_pt_philox_path_matches_plain_on_its_variates(dev):
    B, n, M, R, S = 3, 6, 5, 64, 8
    Q = random_qubo_batch(np.random.default_rng(5), B, n).to(dev)
    seed = draw_seed(torch.Generator().manual_seed(13))
    got = pt_cuda.pt_sample_batch_cuda(Q, R, S, num_replicas=M,
                                       generator=torch.Generator().manual_seed(13))
    hv = tuple(torch.as_tensor(a, device=dev)
               for a in sa_torch.pt_philox_variates(seed, B, M, R, n, S))
    want = tempering.pt_sample_batch_plain(Q, R, S, num_replicas=M, host_variates=hv)
    assert _differ(got, want) <= MAX_DIFF_FRAC


def test_pt_philox_path_matches_oracle(dev):
    rng = np.random.default_rng(3)
    Q = torch.as_tensor(np.triu(rng.uniform(-1.5, 1.5, (1, 5, 5))).astype(np.float32),
                        device=dev)
    s = pt_cuda.pt_sample_batch_cuda(Q, 384, 24, num_replicas=4,
                                     generator=torch.Generator().manual_seed(0))[0]
    _, _, marg, _ = exact_boltzmann(Q[0], beta=1.0)
    assert set(s.unique().tolist()) <= {0.0, 1.0}
    assert torch.allclose(s.mean(0), marg, atol=0.08)


def test_pt_streams_are_per_ladder(dev):
    rng = np.random.default_rng(2)
    Qa = random_qubo_batch(rng, 3, 6, scale=0.2).to(dev)
    Qb = Qa.clone()
    Qb[1:] = random_qubo_batch(rng, 2, 6, scale=0.2).to(dev)
    run = lambda Q, seed: pt_cuda.pt_sample_batch_cuda(
        Q, 64, 10, num_replicas=4, beta_target=0.5, generator=torch.Generator().manual_seed(seed))
    a, b, c = run(Qa, 7), run(Qb, 7), run(Qa, 8)
    assert len({tuple(r) for r in a[0].tolist()}) > 5
    assert torch.equal(a[0], b[0]) and torch.equal(a, run(Qa, 7))
    assert not torch.equal(a[0], c[0])


def test_pt_wrapper_refuses_what_the_kernel_does_not_take(dev):
    """K3's wrapper refuses what K3 does not take; the sampler sends the
    shapes past J_b in shared memory to K5, and those past K5's shared
    paths (n > 3368, a ladder past a cluster) to its global path: no
    shape is refused."""
    Q = torch.zeros((1, 4, 4), device=dev)
    init01, u, sw = _pt_variates(np.random.default_rng(2), 1, 2, 4, 3, 2, dev)
    with pytest.raises(ValueError, match="swap_u"):
        pt_cuda.pt_sample_batch_cuda(Q, 3, 2, num_replicas=2, host_variates=(init01, u, sw[:1]))
    with pytest.raises(ValueError, match="uniforms"):
        pt_cuda.pt_sample_batch_cuda(Q, 3, 2, num_replicas=2,
                                     host_variates=(init01, u.transpose(2, 3), sw))
    sampler = lambda M: api.get_sampler("PT", num_sweeps=2, num_replicas=M)
    # J_b and 2·M energies beyond shared memory; more than 64 rungs; a ladder
    # over a cluster (ladder_bounds_match_plain holds these against plain)
    for n, M in ((257, 2), (241, 16), (4, 65), (300, 33), (3000, 3)):
        if M <= pt_cuda.MAX_RUNGS:
            with pytest.raises(ValueError, match="exceed its bound"):
                pt_cuda.pt_sample_batch_cuda(torch.zeros((1, n, n), device=dev), 2, 2,
                                             num_replicas=M)
        pt_cuda.reset_launch_counts()
        pt_wide_cuda.reset_launch_counts()
        out = sampler(M).sample_batch(None, torch.zeros((1, n, n), device=dev), 2)
        torch.cuda.synchronize()
        assert out.shape == (1, 2, n)
        assert pt_cuda.launch_counts["pt_heatbath"] == 0
        assert sum(pt_wide_cuda.launch_counts.values()) == 1
    # past K5's widest shared n, and a ladder past a cluster of 8 blocks: the global path
    for n, M in ((pt_wide_cuda.max_n() + 1, 1), (4, 8 * 32 + 1), (3000, 17), (3368, 9)):
        pt_wide_cuda.reset_launch_counts()
        out = sampler(M).sample_batch(None, torch.zeros((1, n, n), device=dev), 2)
        torch.cuda.synchronize()
        assert out.shape == (1, 2, n)
        assert pt_wide_cuda.launch_counts == {"pt_wide": 0, "pt_wide_sparse": 0,  # J_g = 0:
                                              "pt_wide_global": 0,  # the sparse pass
                                              "pt_wide_global_sparse": 1}


@pytest.mark.parametrize("solver,counts,kernel,model", [
    ("BMS", gibbs_cuda.launch_counts, "sa_heatbath", "DiscQBM"),
    ("PT", pt_cuda.launch_counts, "pt_heatbath", "DiscQBM"),
    ("PT", pt_wide_cuda.launch_counts, "pt_wide_sparse", "CDQBM"),  # n = 717: K5's row lists
    ("SA", wide_cuda.launch_counts, "anneal_wide_sparse", "CDQBM"),  # ... K4's
    ("BMS", wide_cuda.launch_counts, "anneal_wide_sparse", "CDQBM"),
])
def test_model_steps_launch_the_solver_kernel(dev, solver, counts, kernel, model):
    from qbmx_torch.models.cdqbm import CDQBM
    from qbmx_torch.models.dqbm import DiscQBM

    if model == "DiscQBM":
        m = DiscQBM(dim_input=16, n_hidden_nodes=3, sample_count=32, anneal_steps=20,
                    restricted=False, solver=solver, device=dev)
        x = np.random.default_rng(3).random((40, 16)).astype(np.float32)
    else:  # CDQBM (a)'s geometry, probabilistic pooling: a 717-variable QUBO
        m = CDQBM(pooling_size=4, pooling_type="probabilistic", sequential_layer_sizes=[4],
                  hidden_bias_type="shared", solver=solver, anneal=5, sample_count=8,
                  beta_eff=5.0, device=dev)
        assert m.geo.n_total == 717
        x = np.random.default_rng(3).random((40, 784)).astype(np.float32)
    y = np.arange(40) % 2
    for c in (counts, pt_cuda.launch_counts, pt_wide_cuda.launch_counts,
              wide_cuda.launch_counts):
        for k in c:
            c[k] = 0
    nlls, _ = m.train_epoch(x, y, 10, 0.3)
    preds, probs = m.predict_batch(x)
    torch.cuda.synchronize()
    assert counts[kernel] == 4 + math.ceil(40 / (40 if model == "DiscQBM" else 32))
    assert pt_cuda.launch_counts["pt_heatbath"] + sum(pt_wide_cuda.launch_counts.values()) \
        == (counts[kernel] if solver == "PT" else 0)
    assert sum(wide_cuda.launch_counts.values()) == (
        counts[kernel] if kernel.startswith("anneal_wide") else 0)
    assert np.isfinite(nlls).all() and preds.shape == (40,) and probs.shape == (40, 2)


# -- the layouts of K1 and the geometries of K4 ---------------------------------


def _structured_form(Q, h_extra, S, rule=wide_cuda.METROPOLIS, beta=1.5):
    """(J, h, hot, logr) as the wrappers hand them to the kernels."""
    hs, J = split_qubo(Q)
    h = (hs[:, None, :] + h_extra).contiguous()
    if rule == wide_cuda.METROPOLIS:
        hot, logr = sa_torch.schedule_params(h, J[:, None], S)
    else:
        hot, logr = gibbs.heat_bath_schedule(h, J[:, None], S, beta)
    return J.contiguous(), h, hot, logr


def test_geometry_rules_match_the_kernels(dev):
    """The host's bounds are the kernels': K4's widest n and shared bytes,
    K1's widest n."""
    from qbmx_torch._build import load_kernels

    lib = load_kernels()
    assert lib.qbmx_anneal_wide_max_n() == wide_cuda.max_n() >= 2400
    for n in (242, 717, 2400, wide_cuda.max_n()):
        for c in (1, 7, 32):
            assert lib.qbmx_anneal_wide_smem(n, c) == wide_cuda.smem_bytes(n, c)
            for nnz_pad in (8, 10104, 16392):
                assert lib.qbmx_anneal_wide_sparse_smem(n, c, nnz_pad) \
                    == wide_cuda.sparse_smem_bytes(n, c, nnz_pad)
    assert lib.qbmx_sa_metropolis_max_n() == 241
    assert lib.qbmx_sa_metropolis_thread_max_n() == lib.qbmx_sa_heatbath_thread_max_n() \
        == kernel_call.THREAD_MAX_N
    assert wide_cuda.wide_geometry(1, 1, 1, wide_cuda.max_n() + 1).layout == wide_cuda.GLOBAL
    for chains in (1, 7, 31, 32):
        for sparse in (False, True):
            assert lib.qbmx_anneal_wide_global_smem(chains, sparse) \
                == wide_cuda.global_smem_bytes(chains, sparse) \
                == lib.qbmx_pt_wide_global_smem(chains, sparse)
    assert (lib.qbmx_pt_heatbath_max_n(), lib.qbmx_pt_heatbath_max_rungs()) == \
        (pt_cuda.MAX_N, pt_cuda.MAX_RUNGS)
    for lanes in pt_cuda.LAYOUTS:
        for n, M in ((6, 8), (9, 8), (30, 2), (41, 32), (241, 15), (240, 64)):
            assert lib.qbmx_pt_heatbath_smem(lanes, n, M) == pt_cuda.smem_bytes(lanes, n, M)
    assert lib.qbmx_pt_wide_max_n() == pt_wide_cuda.max_n() == wide_cuda.max_n()
    for n in (2, 241, 300, 717, 2400, pt_wide_cuda.max_n()):
        assert lib.qbmx_pt_wide_max_rungs(n) == pt_wide_cuda.max_rungs(n)
        assert lib.qbmx_pt_wide_block_rungs(n) == pt_wide_cuda.block_rungs(n)
        for c in (1, 8, 32):
            assert lib.qbmx_pt_wide_smem(n, c) == pt_wide_cuda.smem_bytes(n, c)
        for nnz_pad in (8, 10104, 30000):
            assert lib.qbmx_pt_wide_sparse_block_rungs(n, nnz_pad) == \
                pt_wide_cuda.block_rungs(n, nnz_pad)
            for c in (1, 8, 32):
                assert lib.qbmx_pt_wide_sparse_smem(n, c, nnz_pad) == \
                    pt_wide_cuda.sparse_smem_bytes(n, c, nnz_pad)
    # a ladder over the portable cluster size fits the card at both paths' widest blocks
    assert lib.qbmx_pt_wide_max_active_clusters(717, 256, 8, 0) >= 1
    assert lib.qbmx_pt_wide_max_active_clusters(717, 256, 8, 10104) >= 1


# THREAD at n ≤ 8 and past it up to its bound (32, also 4 lanes' widest),
# then its bound + 1; 8 lanes to their widest (64), 16 lanes (128), a warp (241)
K1_SHAPES = [(2, 3, 6, 37, 5), (1, 2, 8, 45, 4), (1, 3, 9, 37, 5),
             (2, 2, kernel_call.THREAD_MAX_N, 35, 4), (1, 3, kernel_call.THREAD_MAX_N + 1, 37, 4),
             (2, 2, 41, 35, 6), (1, 2, 64, 21, 3), (1, 2, 128, 9, 3), (1, 3, 241, 11, 2)]
LAYOUTS = (1, *kernel_call.LANES)  # lanes a chain: THREAD, GROUP 4, 8, 16, LANES


def _holds(lanes: int, n: int, width: int = 0) -> bool:
    """Whether K1 (``width`` 0) or K2 at ``width`` takes n at ``lanes`` lanes a chain."""
    return n <= kernel_call.max_n(lanes, width)


@pytest.mark.parametrize("lanes,G,B,n,R,S", [(lanes, *shape) for lanes in LAYOUTS
                                             for shape in K1_SHAPES
                                             if _holds(lanes, shape[2])])
def test_k1_layouts_match_plain(dev, lanes, G, B, n, R, S):
    """Each layout, forced, against the plain version under host variates;
    B·R is no multiple of a block's chains (128 / lanes)."""
    rng = np.random.default_rng(n + lanes)
    Q, h_extra = _structured(rng, G, B, n, dev)
    hv = _variates(rng, (G, B), n, R, S, dev)
    J, h, hot, logr = _structured_form(Q, h_extra, S)
    flips = torch.zeros(1, dtype=torch.int64, device=dev)
    got = sa_cuda.launch(J, h, hot, logr, R, S, host_variates=hv, lanes=lanes, flips=flips)
    want = sa_torch.sa_sample_groups_plain(Q, h_extra, R, S, host_variates=hv)
    assert got.shape == (G, B, R, n)
    assert _differ(got, want) <= MAX_DIFF_FRAC
    assert 0 < flips.item() <= G * B * R * n * S


@pytest.mark.parametrize("lanes", LAYOUTS)
@pytest.mark.parametrize("n", [2, 5, 8, 12])
def test_k1_layouts_match_oracle(dev, lanes, n):
    """tests/test_samplers.py's problems and bound, for each layout.  At
    n = 12 (THREAD past n = 8) the default schedule freezes SA at β ≈ 1787
    short of the oracle's marginals on every implementation (the plain
    version's are 0.137 off there), so the anneal ends at β = 1, where the
    chains still mix, and the oracle is taken at β = 1."""
    Q = random_qubo_batch(np.random.default_rng(0), 1, n, scale=0.5).to(dev)
    J, h, hot, logr = _structured_form(Q, torch.zeros((1, 1, n), device=dev), 200)
    cold = default_beta_range(Q[0])[1] if n < 12 else 1.0
    if n >= 12:
        hot, logr = sa_torch.schedule_params(h, J[:, None], 200, 0.1, 1.0)
    s = sa_cuda.launch(J, h, hot, logr, 512, 200, lanes=lanes,
                       generator=torch.Generator().manual_seed(n))[0, 0]
    _, _, marg, _ = exact_boltzmann(Q[0], beta=float(cold))
    assert set(s.unique().tolist()) <= {0.0, 1.0}
    assert torch.allclose(s.mean(0), marg, atol=0.12)


@pytest.mark.parametrize("lanes", LAYOUTS)
@pytest.mark.parametrize("n", [7, 12])
def test_k1_layouts_on_their_philox_draws(dev, lanes, n):
    """Each layout draws the same streams: ``philox_variates`` writes them out."""
    G, B, R, S = 2, 3, 40, 6
    rng = np.random.default_rng(31)
    Q, h_extra = _structured(rng, G, B, n, dev)
    J, h, hot, logr = _structured_form(Q, h_extra, S)
    seed = draw_seed(torch.Generator().manual_seed(15))
    got = sa_cuda.launch(J, h, hot, logr, R, S, lanes=lanes,
                         generator=torch.Generator().manual_seed(15))
    hv = tuple(torch.as_tensor(a, device=dev) for a in sa_torch.philox_variates(seed, G, B, R, n, S))
    assert _differ(got, sa_torch.sa_sample_groups_plain(Q, h_extra, R, S, host_variates=hv)) \
        <= MAX_DIFF_FRAC


GROUP_SHAPES = [(2, 3, 41, 37, 40), (1, 2, 9, 45, 20), (1, 2, 64, 13, 20), (1, 1, 241, 5, 17)]


@pytest.mark.parametrize("philox", [False, True])
@pytest.mark.parametrize("lanes,width,G,B,n,R,S", [
    (lanes, width, *shape) for lanes in kernel_call.LANES[:-1] for width in (0, 1, 2, 4)
    for shape in GROUP_SHAPES if _holds(lanes, shape[2], width)])
def test_group_equals_lanes_bit_for_bit(dev, philox, lanes, width, G, B, n, R, S):
    """GROUP (4, 8, 16 lanes a chain) against LANES (a warp a chain), both
    forced, on the same draws: samples, final fields and flips equal bit
    for bit, past two refreshes of the fields; K1 at width 0, K2 at 1, 2,
    4 (quad at 16 lanes)."""
    rng = np.random.default_rng(200 + n + width)
    Q, h_extra = _structured(rng, G, B, n, dev)
    form = _structured_form(Q, h_extra, S, width)
    hv = None if philox else _variates(rng, (G, B), n, R, S, dev)
    got = {}
    for L in (lanes, 32):
        fields = torch.empty((G, B, R, n), device=dev)
        flips = torch.zeros(1, dtype=torch.int64, device=dev)
        kw = dict(host_variates=hv, lanes=L, flips=flips, fields_out=fields,
                  generator=torch.Generator().manual_seed(21) if philox else None)
        if width == 0:
            s = sa_cuda.launch(*form, R, S, **kw)
        else:
            s = gibbs_cuda.launch(*form, R, S, width, **kw)
        got[L] = (s, fields, flips)
    for a, b in zip(got[lanes], got[32]):
        assert torch.equal(a, b)
    assert got[32][2].item() > 0


CHAINS_PER_BLOCK = [1, 3, 5, 31, 32]


@pytest.mark.parametrize("rule,chains,G,B,n,R,S", [
    (rule, chains, *shape) for rule in RULES for chains in CHAINS_PER_BLOCK
    for shape in [(2, 2, 242, 23, 3), (1, 3, 717, 13, 2), (1, 2, 301, 101, 70)]
    if shape[-1] < 64 or rule != "quad"])
def test_wide_geometries_match_plain(dev, rule, chains, G, B, n, R, S):
    """K4 at several chains per block, every rule; B·R is no
    multiple of the block's chains, so the last block has spare chains;
    n = 301 (a ragged last tile) over more sweeps than one refresh period,
    on 202 chains, so that the 1% bound allows the near-tie divergence of
    two.  Quad heat-bath stays at the short shapes here: at this depth the
    incremental fields' rounding diverges 0.8% of its chains on average
    (up to 3% of 202), where a kernel that recomputes every field before
    its decision diverges 0.1% (``cli/compare_kernels.py``'s agreement
    part); ``test_wide_fields_stay_near_a_recompute`` holds quad's fields
    at this shape within their limit, which one lost add would exceed."""
    rng = np.random.default_rng(n + 32 + chains + len(rule))
    Q, h_extra = _structured(rng, G, B, n, dev)
    hv = _variates(rng, (G, B), n, R, S, dev)
    code = {"metropolis": 0, "single": 1, "pair": 2, "quad": 4}[rule]
    J, h, hot, logr = _structured_form(Q, h_extra, S, code)
    geo = wide_cuda.WideGeometry.of(G, B, R, n, chains)
    got = wide_cuda.launch(J, h, hot, logr, R, S, code, host_variates=hv, geometry=geo)
    assert got.shape == (G, B, R, n)
    assert _differ(got, _plain_groups(rule, Q, h_extra, R, S, hv)) <= MAX_DIFF_FRAC


@pytest.mark.parametrize("rule", list(RULES))
def test_wide_kernel_at_its_widest_n(dev, rule):
    n = wide_cuda.switch_n()  # the widest n the rule gives the shared layout
    G, B, R, S = 1, 1, 5, 2
    rng = np.random.default_rng(60 + len(rule))
    Q, h_extra = _structured(rng, G, B, n, dev)
    hv = _variates(rng, (G, B), n, R, S, dev)
    wide_cuda.reset_launch_counts()
    got = _kernel_groups(rule, Q, h_extra, R, S, host_variates=hv)
    assert wide_cuda.launch_counts["anneal_wide"] == 1
    assert _differ(got, _plain_groups(rule, Q, h_extra, R, S, hv)) <= MAX_DIFF_FRAC


@pytest.mark.parametrize("chains", [4, 32])
@pytest.mark.parametrize("n", [2, 5, 8])
def test_wide_geometries_match_oracle(dev, chains, n):
    """K4 forced, 4 and 32 chains a block: K1's and K2's oracle bounds."""
    def geo(R):
        return wide_cuda.WideGeometry.of(1, 1, R, n, chains)

    Q = random_qubo_batch(np.random.default_rng(0), 1, n, scale=0.5).to(dev)
    R, S = 512, 200
    J, h, hot, logr = _structured_form(Q, torch.zeros((1, 1, n), device=dev), S)
    s = wide_cuda.launch(J, h, hot, logr, R, S, wide_cuda.METROPOLIS, geometry=geo(R),
                         generator=torch.Generator().manual_seed(n))[0, 0]
    _, cold = default_beta_range(Q[0])
    _, _, marg, _ = exact_boltzmann(Q[0], beta=float(cold))
    assert torch.allclose(s.mean(0), marg, atol=0.12)
    Q = torch.as_tensor(np.triu(np.random.default_rng(11).uniform(-1, 1, (1, n, n)))
                        .astype(np.float32), device=dev)
    R, S = 2048, 64
    J, h, hot, logr = _structured_form(Q, torch.zeros((1, 1, n), device=dev), S,
                                       wide_cuda.PAIR, 1.0)
    s = wide_cuda.launch(J, h, hot, logr, R, S, wide_cuda.PAIR, geometry=geo(R),
                         generator=torch.Generator().manual_seed(4))[0, 0]
    _, _, marg, pair_m = exact_boltzmann(Q[0], beta=1.0)
    assert torch.allclose(s.mean(0), marg, atol=0.05)
    assert torch.allclose(s.T @ s / R, pair_m, atol=0.07)


@pytest.mark.parametrize("rule", [0, 1, 2, 4])
@pytest.mark.parametrize("G,B,n,R,S", [(2, 2, 300, 16, 100), (1, 2, 301, 101, 70)])
def test_wide_fields_stay_near_a_recompute(dev, rule, G, B, n, R, S):
    """The final incremental fields against h + J·s in float64, after more
    sweeps than one refresh period, within ``wide_cuda.field_drift_bound``
    (chip_smoke.py checks the main path's depth), for every rule, quad at
    the deep shape of ``test_wide_geometries_match_plain`` included; one
    field that lost one add of its row's median |J_jk| would not be."""
    rng = np.random.default_rng(70 + rule + n)
    Q, h_extra = _structured(rng, G, B, n, dev)
    J, h, hot, logr = _structured_form(Q, h_extra, S, rule)
    fields = torch.empty((G, B, R, n), device=dev)
    flips = torch.zeros(2, dtype=torch.int64, device=dev)
    s = wide_cuda.launch(J, h, hot, logr, R, S, rule, fields_out=fields, flips=flips,
                         generator=torch.Generator().manual_seed(3))
    exact = h.double()[:, :, None] + torch.einsum("gbrj,gij->gbri", s.double(), J.double())
    bound = wide_cuda.field_drift_bound(h, J, S)
    assert ((fields.double() - exact).abs() <= bound).all()
    assert 0 < flips[0].item() <= G * B * R * n * S
    assert flips[1].item() == flips[0].item() * (n - 1)  # a random QUBO: every J_ij, i ≠ j
    typical = J[0].abs().masked_fill(J[0] == 0, float("nan")).nanmedian(dim=1).values
    lost = fields.double().clone()
    lost[0, 0, 0] -= typical.double()  # every field of one chain, one add short
    assert ((lost - exact).abs()[0, 0, 0] > bound[0, 0, 0]).all()


# -- the layouts of K2 and K3 ----------------------------------------------------

K2_SHAPES = [(2, 3, 6, 37, 5), (1, 2, 7, 45, 4), (1, 3, 9, 37, 5),
             (1, 3, kernel_call.THREAD_MAX_N, 37, 4), (2, 2, kernel_call.THREAD_MAX_N + 1, 35, 4),
             (2, 3, 41, 100, 12), (1, 2, 64, 21, 3), (1, 2, 128, 9, 3), (1, 3, 241, 11, 2)]


@pytest.mark.parametrize("lanes,width,G,B,n,R,S", [
    (lanes, width, *shape) for lanes in LAYOUTS for width in (1, 2, 4) for shape in K2_SHAPES
    if _holds(lanes, shape[2], width)])
def test_k2_layouts_match_plain(dev, lanes, width, G, B, n, R, S):
    """Each K2 layout, forced, against the plain version under host
    variates; B·R is no multiple of a block's chains (128 / lanes)."""
    rng = np.random.default_rng(n + lanes + width)
    Q, h_extra = _structured(rng, G, B, n, dev)
    hv = _variates(rng, (G, B), n, R, S, dev)
    J, h, hot, logr = _structured_form(Q, h_extra, S, width)
    flips = torch.zeros(1, dtype=torch.int64, device=dev)
    got = gibbs_cuda.launch(J, h, hot, logr, R, S, width, host_variates=hv, lanes=lanes,
                            flips=flips)
    want = gibbs.gibbs_sample_groups_plain(Q, h_extra, R, S, beta=1.5, host_variates=hv,
                                           **WIDTHS[width])
    assert got.shape == (G, B, R, n)
    assert _differ(got, want) <= MAX_DIFF_FRAC
    assert 0 < flips.item() <= G * B * R * n * S


@pytest.mark.parametrize("lanes,width,n", [
    (lanes, width, n) for lanes in LAYOUTS for width in (1, 2, 4) for n in (6, 12)
    if _holds(lanes, n, width)])
def test_k2_layouts_match_oracle(dev, lanes, width, n):
    """tests/test_gibbs_pt_pallas_debug.py's problems and bars, each layout;
    at n = 12 (THREAD past n = 8) the same draw of couplings, 4× the reads."""
    seed, reads, sweeps, atol = (9, 384, 48, 0.08) if width == 1 else (11, 2048, 64, 0.05)
    reads *= 1 if n == 6 else 4
    Q = torch.as_tensor(np.triu(np.random.default_rng(seed).uniform(-1, 1, (1, n, n)))
                        .astype(np.float32), device=dev)
    J, h, hot, logr = _structured_form(Q, torch.zeros((1, 1, n), device=dev), sweeps, width, 1.0)
    s = gibbs_cuda.launch(J, h, hot, logr, reads, sweeps, width, lanes=lanes,
                          generator=torch.Generator().manual_seed(4))[0, 0]
    _, _, marg, pair_m = exact_boltzmann(Q[0], beta=1.0)
    assert set(s.unique().tolist()) <= {0.0, 1.0}
    assert torch.allclose(s.mean(0), marg, atol=atol)
    if width > 1:
        assert torch.allclose(s.T @ s / reads, pair_m, atol=0.07)


@pytest.mark.parametrize("lanes,width,n", [
    (lanes, width, n) for lanes in LAYOUTS for width in (1, 2, 4) for n in (7, 12)
    if _holds(lanes, n, width)])
def test_k2_layouts_on_their_philox_draws(dev, lanes, width, n):
    """Each layout draws K1's streams: ``philox_variates`` writes them out."""
    G, B, R, S = 2, 3, 40, 6
    rng = np.random.default_rng(33 + width)
    Q, h_extra = _structured(rng, G, B, n, dev)
    J, h, hot, logr = _structured_form(Q, h_extra, S, width)
    seed = draw_seed(torch.Generator().manual_seed(16))
    got = gibbs_cuda.launch(J, h, hot, logr, R, S, width, lanes=lanes,
                            generator=torch.Generator().manual_seed(16))
    hv = tuple(torch.as_tensor(a, device=dev) for a in sa_torch.philox_variates(seed, G, B, R, n, S))
    want = gibbs.gibbs_sample_groups_plain(Q, h_extra, R, S, beta=1.5, host_variates=hv,
                                           **WIDTHS[width])
    assert _differ(got, want) <= MAX_DIFF_FRAC


@pytest.mark.parametrize("lanes,width", [(lanes, width) for lanes in kernel_call.LANES
                                         for width in (1, 2, 4) if _holds(lanes, 41, width)])
def test_k2_fields_stay_near_a_recompute(dev, lanes, width):
    """The final incremental fields of GROUP and LANES at the CDQBM default
    call's width against h + J·s in float64, after more sweeps than one
    refresh period, within ``wide_cuda.field_drift_bound`` at K2's period;
    one field that lost one add of its row's median |J_jk| would not be.
    The THREAD layout keeps no fields and refuses ``fields_out``."""
    G, B, n, R, S = 2, 3, 41, 100, 40
    rng = np.random.default_rng(80 + width)
    Q, h_extra = _structured(rng, G, B, n, dev)
    J, h, hot, logr = _structured_form(Q, h_extra, S, width)
    fields = torch.empty((G, B, R, n), device=dev)
    s = gibbs_cuda.launch(J, h, hot, logr, R, S, width, fields_out=fields, lanes=lanes,
                          generator=torch.Generator().manual_seed(3))
    exact = h.double()[:, :, None] + torch.einsum("gbrj,gij->gbri", s.double(), J.double())
    bound = wide_cuda.field_drift_bound(h, J, S, gibbs_cuda.REFRESH_PERIOD)
    assert ((fields.double() - exact).abs() <= bound).all()
    typical = J[0].abs().masked_fill(J[0] == 0, float("nan")).nanmedian(dim=1).values
    lost = fields.double().clone()
    lost[0, 0, 0] -= typical.double()
    assert ((lost - exact).abs()[0, 0, 0] > bound[0, 0, 0]).all()
    with pytest.raises(ValueError, match="keeps no fields"):
        gibbs_cuda.launch(J[:, :6, :6].contiguous(), h[..., :6].contiguous(), hot, logr, R, S,
                          width, lanes=1, fields_out=fields[..., :6].contiguous())
    with pytest.raises(ValueError, match="keeps no fields"):
        sa_cuda.launch(J[:, :6, :6].contiguous(), h[..., :6].contiguous(), hot, logr, R, S,
                       lanes=1, fields_out=fields[..., :6].contiguous())


PT_LAYOUTS = {"rung": pt_cuda.RUNG, "4 lanes": 4, "8 lanes": 8, "16 lanes": 16,
              "warp": pt_cuda.WARP}
# n ≤ 8 (RUNG's registers), past it to RUNG's widest (32) and 4 lanes', past
# 8 lanes' (64) at the CDQBM (b) width, 16 lanes' (128) at 100; M from one
# rung to 64, ladders within a warp and over warps at each L
PT_SHAPES = [(3, 6, 8, 70, 12), (2, 5, 3, 33, 6), (1, 7, 1, 16, 3), (2, 8, 32, 9, 5),
             (1, 4, 5, 13, 40), (3, 9, 8, 70, 20), (2, 9, 4, 33, 17), (2, 16, 16, 21, 18),
             (1, 16, 2, 45, 20), (2, 32, 8, 19, 17), (1, 32, 32, 5, 6), (2, 41, 8, 23, 18),
             (1, 41, 3, 30, 20), (1, 41, 64, 3, 4), (1, 100, 4, 9, 17), (1, 100, 13, 3, 6)]


def _pt_holds(layout: str, n: int, M: int) -> bool:
    """Whether K3's ``layout`` takes width n and M rungs."""
    lanes = PT_LAYOUTS[layout]
    return n <= pt_cuda.max_n(lanes) and (lanes != pt_cuda.RUNG or M <= pt_cuda.RUNG_MAX_M)


@pytest.mark.parametrize("layout,B,n,M,R,S", [(layout, *shape) for layout in PT_LAYOUTS
                                              for shape in PT_SHAPES
                                              if _pt_holds(layout, shape[1], shape[2])])
def test_pt_layouts_match_plain(dev, layout, B, n, M, R, S):
    """Each K3 layout, forced, against the plain version under host
    variates; R is no multiple of a block's ladders, nor of a warp's."""
    rng = np.random.default_rng(400 + n + M)
    Q = random_qubo_batch(rng, B, n).to(dev)
    hv = _pt_variates(rng, B, M, n, R, S, dev)
    got = pt_cuda.pt_sample_batch_cuda(Q, R, S, num_replicas=M, host_variates=hv,
                                       _layout=PT_LAYOUTS[layout])
    want = tempering.pt_sample_batch_plain(Q, R, S, num_replicas=M, host_variates=hv)
    assert got.shape == (B, R, n) and set(got.unique().tolist()) <= {0.0, 1.0}
    assert _differ(got, want) <= MAX_DIFF_FRAC


@pytest.mark.parametrize("philox", [False, True])
@pytest.mark.parametrize("lanes,B,n,M,R,S", [
    (lanes, *shape) for lanes in pt_cuda.GROUP_LANES for shape in PT_SHAPES
    if shape[1] <= pt_cuda.max_n(lanes) and shape[-1] > 1])
def test_pt_group_equals_warp_bit_for_bit(dev, philox, lanes, B, n, M, R, S):
    """GROUP (4, 8, 16 lanes a rung, its ladders within a warp or over
    warps) against WARP (a rung a warp), both forced, on the same draws:
    the same samples bit for bit, past a refresh of the fields wherever
    S > 16."""
    rng = np.random.default_rng(700 + n + M)
    Q = random_qubo_batch(rng, B, n).to(dev)
    hv = None if philox else _pt_variates(rng, B, M, n, R, S, dev)
    got = [pt_cuda.pt_sample_batch_cuda(
        Q, R, S, num_replicas=M, host_variates=hv, _layout=L,
        generator=torch.Generator().manual_seed(23) if philox else None)
        for L in (lanes, pt_cuda.WARP)]
    assert torch.equal(got[0], got[1])


@pytest.mark.parametrize("layout", list(PT_LAYOUTS))
@pytest.mark.parametrize("n,M,reads", [(5, 4, 384), (12, 4, 1024), (9, 16, 512)])
def test_pt_layouts_match_oracle(dev, layout, n, M, reads):
    """Each layout's Philox streams against the exact marginals at beta 1
    (tests/test_gibbs_pt_pallas_debug.py's problem at n = 5; RUNG past
    n = 8; a GROUP ladder over warps at M = 16)."""
    if not _pt_holds(layout, n, M):
        pytest.skip(f"{layout} does not take n={n}, M={M}")
    rng = np.random.default_rng(3)
    Q = torch.as_tensor(np.triu(rng.uniform(-1.5, 1.5, (1, n, n))).astype(np.float32),
                        device=dev)
    s = pt_cuda.pt_sample_batch_cuda(Q, reads, 24, num_replicas=M, _layout=PT_LAYOUTS[layout],
                                     generator=torch.Generator().manual_seed(0))[0]
    _, _, marg, _ = exact_boltzmann(Q[0], beta=1.0)
    assert set(s.unique().tolist()) <= {0.0, 1.0}
    assert torch.allclose(s.mean(0), marg, atol=0.08)


@pytest.mark.parametrize("layout,B,n,M,R,S", [
    *[(layout, 3, 6, 5, 64, 8) for layout in PT_LAYOUTS],
    *[(layout, 2, 41, 8, 16, 20) for layout in ("8 lanes", "16 lanes", "warp")],
    *[(layout, 2, 9, 8, 40, 20) for layout in PT_LAYOUTS],
    *[(layout, 1, 20, 40, 8, 4) for layout in ("4 lanes", "8 lanes", "16 lanes", "warp")],
    *[(layout, 2, 32, 16, 9, 17) for layout in PT_LAYOUTS]])
def test_pt_layouts_on_their_philox_draws(dev, layout, B, n, M, R, S):
    """Each layout draws the streams ``pt_philox_variates`` writes out."""
    Q = random_qubo_batch(np.random.default_rng(5 + n), B, n).to(dev)
    seed = draw_seed(torch.Generator().manual_seed(13))
    got = pt_cuda.pt_sample_batch_cuda(Q, R, S, num_replicas=M, _layout=PT_LAYOUTS[layout],
                                       generator=torch.Generator().manual_seed(13))
    hv = tuple(torch.as_tensor(a, device=dev)
               for a in sa_torch.pt_philox_variates(seed, B, M, R, n, S))
    want = tempering.pt_sample_batch_plain(Q, R, S, num_replicas=M, host_variates=hv)
    assert _differ(got, want) <= MAX_DIFF_FRAC


# -- parallel tempering past shared memory (qbmx_torch/csrc/pt_wide.cu, K5) ------


def _pt_groups(rng, G, B, n, dev):
    Q = random_qubo_batch(rng, G, n).to(dev)
    return Q, torch.as_tensor(rng.normal(size=(G, B, n)).astype(np.float32), device=dev)


@pytest.mark.parametrize("G,B,n,M,R,S", [
    (2, 4, 300, 8, 16, 6),   # the structured form at n = 300
    (1, 2, 717, 8, 8, 3),    # CDQBM (a)'s width
    (1, 1, 241, 16, 8, 4),   # a ladder K3 cannot hold at n = 241
    (2, 3, 257, 2, 10, 5),
    (1, 2, 300, 1, 8, 3),    # one rung: no exchange
    (1, 1, 400, 5, 9, 4),    # an odd ladder
    (1, 2, 242, 32, 4, 3),   # a ladder a block, 32 warps
])
def test_pt_wide_kernel_matches_plain(dev, G, B, n, M, R, S):
    """K5 through the sampler's structured entry against the plain version
    on the densified batch, under the same host variates."""
    rng = np.random.default_rng(500 + n + M)
    Q, h_extra = _pt_groups(rng, G, B, n, dev)
    hv = _pt_variates(rng, G * B, M, n, R, S, dev)
    assert pt_wide_cuda.pt_route(G, B, M, R, n) == "pt_wide"
    pt_wide_cuda.reset_launch_counts()
    got = pt_wide_cuda.pt_sample_groups(Q, h_extra, R, S, num_replicas=M, host_variates=hv)
    torch.cuda.synchronize()
    assert pt_wide_cuda.launch_counts["pt_wide"] == 1
    want = tempering.pt_sample_batch_plain(api.densify_groups(Q, h_extra), R, S, num_replicas=M,
                                           host_variates=hv)
    assert got.shape == (G, B, R, n) and set(got.unique().tolist()) <= {0.0, 1.0}
    assert _differ(got, want.reshape(G, B, R, n)) <= MAX_DIFF_FRAC


@pytest.mark.parametrize("G,B,n,M,R,S,L", [
    (2, 2, 300, 8, 10, 6, 3),  # 20 ladders a group: the last block holds 2 and a spare
    (1, 3, 717, 8, 11, 4, 4),  # CDQBM (a)'s 4 ladders a block; 33 ladders: 3 spares
    (1, 2, 301, 5, 7, 5, 6),   # 30 warps a block; 14 ladders: 4 spares
])
def test_pt_wide_geometries_match_plain(dev, G, B, n, M, R, S, L):
    """K5 with L ladders a block, forced past ``pt_wide_geometry`` (which
    gives these few ladders one a block): the ladders of a block share its
    energies, and the last block's spare ladders repeat a ladder and write
    nothing; against the plain version under host variates."""
    assert B * R % L != 0 and pt_wide_cuda.pt_wide_geometry(G, B, M, R, n).ladders_per_block == 1
    rng = np.random.default_rng(600 + n + L)
    Q, h_extra = _pt_groups(rng, G, B, n, dev)
    hv = _pt_variates(rng, G * B, M, n, R, S, dev)
    got = pt_wide_cuda.launch(*pt_wide_cuda.structured_form(Q, h_extra, M), R, S,
                              host_variates=hv,
                              geometry=pt_wide_cuda.PTWideGeometry.of(G, B, M, R, n, L))
    want = tempering.pt_sample_batch_plain(api.densify_groups(Q, h_extra), R, S, num_replicas=M,
                                           host_variates=hv)
    assert got.shape == (G, B, R, n) and set(got.unique().tolist()) <= {0.0, 1.0}
    assert _differ(got, want.reshape(G, B, R, n)) <= MAX_DIFF_FRAC


def test_pt_wide_dense_entry_matches_plain(dev):
    """A dense batch is G = B groups of one problem."""
    B, n, M, R, S = 3, 300, 4, 12, 5
    rng = np.random.default_rng(9)
    Q = random_qubo_batch(rng, B, n).to(dev)
    hv = _pt_variates(rng, B, M, n, R, S, dev)
    got = pt_wide_cuda.pt_sample_batch(Q, R, S, num_replicas=M, host_variates=hv)
    want = tempering.pt_sample_batch_plain(Q, R, S, num_replicas=M, host_variates=hv)
    assert got.shape == (B, R, n) and _differ(got, want) <= MAX_DIFF_FRAC


@pytest.mark.parametrize("G,B,n,M,R,S", [(2, 2, 300, 4, 16, 6), (1, 1, 8, 5, 40, 12)])
def test_pt_wide_on_its_philox_draws(dev, G, B, n, M, R, S):
    """K5 draws the streams ``pt_philox_variates(..., var_shift=10)``
    writes out (problems numbered g·B + b)."""
    rng = np.random.default_rng(n + M)
    Q, h_extra = _pt_groups(rng, G, B, n, dev)
    seed = draw_seed(torch.Generator().manual_seed(21))
    got = pt_wide_cuda.launch(*pt_wide_cuda.structured_form(Q, h_extra, M), R, S,
                              generator=torch.Generator().manual_seed(21))
    hv = tuple(torch.as_tensor(a, device=dev) for a in sa_torch.pt_philox_variates(
        seed, G * B, M, R, n, S, var_shift=pt_wide_cuda.VAR_SHIFT))
    want = tempering.pt_sample_batch_plain(api.densify_groups(Q, h_extra), R, S, num_replicas=M,
                                           host_variates=hv)
    assert _differ(got, want.reshape(G, B, R, n)) <= MAX_DIFF_FRAC


@pytest.mark.parametrize("path", [pt_wide_cuda.DENSE, pt_wide_cuda.SPARSE])
@pytest.mark.parametrize("n", [2, 5, 8])
def test_pt_wide_forced_matches_oracle(dev, n, path):
    """K5 launched directly at narrow widths, past the routing, on each
    path: K3's bar (0.08) against the exact marginals at beta 1."""
    Q = torch.as_tensor(np.triu(np.random.default_rng(3).uniform(-1.5, 1.5, (1, n, n)))
                        .astype(np.float32), device=dev)
    s = pt_wide_cuda.launch(*pt_wide_cuda.structured_form(Q, torch.zeros((1, 1, n), device=dev),
                                                          4), 384, 24, path=path,
                            generator=torch.Generator().manual_seed(0))[0, 0]
    _, _, marg, _ = exact_boltzmann(Q[0], beta=1.0)
    assert set(s.unique().tolist()) <= {0.0, 1.0}
    assert torch.allclose(s.mean(0), marg, atol=0.08)


def test_pt_wide_streams_are_per_problem(dev):
    rng = np.random.default_rng(2)
    Qa = random_qubo_batch(rng, 3, 300, scale=0.02).to(dev)
    Qb = Qa.clone()
    Qb[1:] = random_qubo_batch(rng, 2, 300, scale=0.02).to(dev)
    run = lambda Q, seed: pt_wide_cuda.pt_sample_batch(
        Q, 16, 4, num_replicas=4, beta_target=0.5, generator=torch.Generator().manual_seed(seed))
    a, b, c = run(Qa, 7), run(Qb, 7), run(Qa, 8)
    assert torch.equal(a[0], b[0]) and torch.equal(a, run(Qa, 7))
    assert not torch.equal(a[0], c[0])


@pytest.mark.parametrize("problem,S", [("dense", 100), ("CDQBM (a)", 100), ("CDQBM (a)", 1000)])
def test_pt_wide_fields_and_energies_stay_near_a_recompute(dev, problem, S):
    """Every rung's final fields against h + J·s and its energy against
    h·s + ½ sᵀJs in float64, past a refresh period, within
    ``field_drift_bound`` and ``energy_drift_bound``, on the dense path (a
    random QUBO at n = 300) and the sparse one (CDQBM (a)'s QUBOs, also at
    the main path's S = 1000); a field one median |J_jk| short, and an
    energy one flip's |f_i| short, would not be."""
    G, B, M, R = 2, 2, 4, 8
    rng = np.random.default_rng(77)
    Q, h_extra = _pt_groups(rng, G, B, 300, dev) if problem == "dense" else \
        cdqbm_a_qubos(B, dev)
    n = Q.shape[-1]
    J, h, betas, dbeta = pt_wide_cuda.structured_form(Q, h_extra, M)
    states, fields = (torch.empty((G * B * M, R, n), device=dev) for _ in range(2))
    energy = torch.empty((G * B * M, R), device=dev)
    flips = torch.zeros(2, dtype=torch.int64, device=dev)
    pt_wide_cuda.reset_launch_counts()
    pt_wide_cuda.launch(J, h, betas, dbeta, R, S, states_out=states, fields_out=fields,
                        energy_out=energy, flips=flips,
                        generator=torch.Generator().manual_seed(5))
    assert pt_wide_cuda.launch_counts["pt_wide" if problem == "dense" else "pt_wide_sparse"] == 1
    s = states.double().reshape(G, B, M, R, n)
    exact_f = h.double()[:, :, None, None] + torch.einsum("gbmrj,gij->gbmri", s, J.double())
    exact_e = 0.5 * (s * (h.double()[:, :, None, None] + exact_f)).sum(-1)
    fb = wide_cuda.field_drift_bound(h, J, S)[:, :, None]  # (G, B, 1, 1, n)
    eb = pt_wide_cuda.energy_drift_bound(h, J, S)  # (G, B, 1, 1)
    f = fields.double().reshape(G, B, M, R, n)
    e = energy.double().reshape(G, B, M, R)
    assert ((f - exact_f).abs() <= fb).all() and ((e - exact_e).abs() <= eb).all()
    assert 0 < flips[0].item() <= G * B * M * R * n * S
    assert flips[0].item() < flips[1].item() <= flips[0].item() * (n - 1)
    typical = J[0].abs().masked_fill(J[0] == 0, float("nan")).nanmedian(dim=1).values
    coupled = ~typical.isnan()  # a row without nonzeros takes no add to lose
    assert ((f[0, 0, 0, 0] - typical.double() - exact_f[0, 0, 0, 0]).abs()
            > fb[0, 0, 0, 0])[coupled].all()
    flip = exact_f[0, 0, 0, 0].abs().median()
    assert (e[0, 0, 0, 0] - flip - exact_e[0, 0, 0, 0]).abs() > eb[0, 0, 0, 0]


# -- K5's sparse path and its ladders over a thread block cluster -----------------


@pytest.mark.parametrize("B,M,R,S", [(2, 8, 8, 3), (3, 5, 6, 4)])
def test_pt_wide_sparse_matches_plain(dev, B, M, R, S):
    """The sampler's structured entry at CDQBM (a)'s width and QUBOs (J_g
    98% zeros) launches the sparse path, against the plain version on the
    densified batch under the same host variates."""
    Q, h_extra = cdqbm_a_qubos(B, dev)
    G, n = 2, Q.shape[-1]
    hv = _pt_variates(np.random.default_rng(B + M), G * B, M, n, R, S, dev)
    pt_wide_cuda.reset_launch_counts()
    got = pt_wide_cuda.pt_sample_groups(Q, h_extra, R, S, num_replicas=M, host_variates=hv)
    torch.cuda.synchronize()
    assert pt_wide_cuda.launch_counts == {"pt_wide": 0, "pt_wide_sparse": 1, "pt_wide_global": 0,
                                          "pt_wide_global_sparse": 0}
    want = tempering.pt_sample_batch_plain(api.densify_groups(Q, h_extra), R, S, num_replicas=M,
                                           host_variates=hv)
    assert got.shape == (G, B, R, n) and set(got.unique().tolist()) <= {0.0, 1.0}
    assert _differ(got, want.reshape(G, B, R, n)) <= MAX_DIFF_FRAC


def test_pt_wide_sparse_on_its_philox_draws(dev):
    """The sparse path draws the streams ``pt_philox_variates(...,
    var_shift=10)`` writes out, as the dense path does."""
    B, M, R, S = 2, 8, 8, 4
    Q, h_extra = cdqbm_a_qubos(B, dev, seed=1)
    n = Q.shape[-1]
    seed = draw_seed(torch.Generator().manual_seed(22))
    got = pt_wide_cuda.launch(*pt_wide_cuda.structured_form(Q, h_extra, M), R, S,
                              path=pt_wide_cuda.SPARSE, generator=torch.Generator().manual_seed(22))
    hv = tuple(torch.as_tensor(a, device=dev) for a in sa_torch.pt_philox_variates(
        seed, 2 * B, M, R, n, S, var_shift=pt_wide_cuda.VAR_SHIFT))
    want = tempering.pt_sample_batch_plain(api.densify_groups(Q, h_extra), R, S, num_replicas=M,
                                           host_variates=hv)
    assert _differ(got, want.reshape(2, B, R, n)) <= MAX_DIFF_FRAC


def _sparse_random(rng, G, n, density, dev):
    """Random QUBOs with about ``density`` of their couplings nonzero."""
    Q = random_qubo_batch(rng, G, n)
    keep = torch.as_tensor(rng.random((G, n, n)) < density) | torch.eye(n, dtype=torch.bool)
    return (Q * keep).to(dev), torch.as_tensor(rng.normal(size=(G, 2, n)).astype(np.float32),
                                               device=dev)


@pytest.mark.parametrize("problem,M,R,S", [
    ("CDQBM (a)", 8, 4, 70),    # past the refresh at sweep 64
    ("sparse n=300", 6, 5, 70),
    ("CDQBM (a)", 40, 2, 66),   # a ladder over a cluster of 2 blocks on both paths
])
def test_pt_wide_paths_agree_bit_for_bit(dev, problem, M, R, S):
    """The two paths, forced on one input and one seed, take the same
    decisions from the same fields: equal samples, states, fields (a zero's
    sign aside, which ``torch.equal`` does not see), energies and counters,
    between refreshes and across one."""
    if problem == "CDQBM (a)":
        Q, h_extra = cdqbm_a_qubos(2, dev, seed=2)
    else:
        Q, h_extra = _sparse_random(np.random.default_rng(31), 2, 300, 0.05, dev)
    G, B, n = h_extra.shape
    form = pt_wide_cuda.structured_form(Q, h_extra, M)
    runs = {}
    for path in (pt_wide_cuda.DENSE, pt_wide_cuda.SPARSE):
        outs = dict(states_out=torch.empty((G * B * M, R, n), device=dev),
                    fields_out=torch.empty((G * B * M, R, n), device=dev),
                    energy_out=torch.empty((G * B * M, R), device=dev),
                    flips=torch.zeros(2, dtype=torch.int64, device=dev))
        pt_wide_cuda.reset_launch_counts()
        out = pt_wide_cuda.launch(*form, R, S, path=path, **outs,
                                  generator=torch.Generator().manual_seed(8))
        torch.cuda.synchronize()
        assert pt_wide_cuda.launch_counts["pt_wide_sparse" if path == "sparse" else "pt_wide"] == 1
        runs[path] = dict(out=out, **outs)
    for key, dense in runs[pt_wide_cuda.DENSE].items():
        assert torch.equal(dense, runs[pt_wide_cuda.SPARSE][key]), key
    assert runs[pt_wide_cuda.DENSE]["flips"][0] > 0


@pytest.mark.parametrize("G,B,n,M,R,S,problem,path", [
    (1, 1, 4, 65, 8, 6, "random", "sparse"),     # past K3's 64 rungs: 3 blocks of 22
    (1, 2, 300, 33, 4, 5, "random", "dense"),    # past a block's 32 warps: 2 blocks of 17
    (1, 2, 1416, 21, 3, 3, "random", "dense"),   # past a block's 20 rungs at the rule's widest
                                                 # dense n: 2 blocks
    (2, 2, 717, 40, 4, 4, "CDQBM (a)", "sparse"),
    (1, 2, 717, 40, 4, 4, "random", "dense"),
    (1, 1, 241, 200, 2, 3, "random", "dense"),   # 7 blocks of 29, 3 spare warps
])
def test_pt_wide_ladders_over_a_cluster_match_plain(dev, G, B, n, M, R, S, problem, path):
    """A ladder of more rungs than one block holds spreads over a thread
    block cluster (its energies through distributed shared memory): the
    sampler's entry routes the shapes K3 and a block cannot hold to K5
    (ROADMAP Queue 3 item 1), against the plain version on host variates."""
    rng = np.random.default_rng(n + M)
    Q, h_extra = cdqbm_a_qubos(B, dev, seed=3) if problem == "CDQBM (a)" else \
        _pt_groups(rng, G, B, n, dev)
    hv = _pt_variates(rng, G * B, M, n, R, S, dev)
    assert pt_wide_cuda.pt_route(G, B, M, R, n) == "pt_wide"
    pt_wide_cuda.reset_launch_counts()
    got = pt_wide_cuda.pt_sample_groups(Q, h_extra, R, S, num_replicas=M, host_variates=hv)
    torch.cuda.synchronize()
    assert pt_wide_cuda.launch_counts["pt_wide_sparse" if path == "sparse" else "pt_wide"] == 1
    J = split_qubo(Q)[1]
    nnz = pt_wide_cuda.group_nnz(pt_wide_cuda.row_nnz(J))
    geo = pt_wide_cuda.pt_wide_geometry(G, B, M, R, n, pt_wide_cuda.padded(max(nnz)))
    assert geo.path == path and geo.cluster > 1
    want = tempering.pt_sample_batch_plain(api.densify_groups(Q, h_extra), R, S, num_replicas=M,
                                           host_variates=hv)
    assert got.shape == (G, B, R, n) and set(got.unique().tolist()) <= {0.0, 1.0}
    assert _differ(got, want.reshape(G, B, R, n)) <= MAX_DIFF_FRAC


# -- the RBM family: cuBLAS products, no hand-written kernel -------------------


@pytest.mark.parametrize("method", ["discriminative", "generative", "hybrid", "pcd"])
def test_rbm_step_on_the_card_matches_the_cpu(dev, method):
    """One f32 step per method on the card and on the CPU from the same
    parameters, data and host variates: within 1e-5 (float32 products
    summed in another order); the PCD chain equal and binary."""
    from qbmx_torch.models import rbm

    rng = np.random.default_rng(11)
    B, V, H, C = 64, 784, 9, 2
    d = {k: (0.1 * rng.normal(size=s)).astype(np.float32) for k, s in
         zip(rbm.FIELDS, ((V, H), (V,), (H,), (C,), (C, H)))}
    x = (rng.random((B, V)) > 0.5).astype(np.float32)
    y = rng.integers(0, C, B)
    k = 2 if method == "pcd" else 1
    variates = []
    for _ in range(k if method == "pcd" else 0):
        variates += [rng.random((B, H)), rng.random((B, V)), rng.gumbel(size=(B, C))]
    variates += [] if method == "pcd" else [rng.random((B, H))]
    step = rbm.make_train_step(C, method=method, cd_k=k, generative_factor=0.5)
    outs = {}
    for device in ("cpu", dev):
        args = (rbm.params_from_numpy(d, device), torch.as_tensor(x, device=device),
                torch.as_tensor(y, device=device), 0.0871)
        chain = ((args[1], torch.nn.functional.one_hot(args[2], C).float()),) \
            if method == "pcd" else ()
        outs[str(device)] = step(*args, *chain, variates=variates)
    cpu, card = outs["cpu"], outs[str(dev)]
    for f in rbm.FIELDS:
        np.testing.assert_allclose(getattr(card[0], f).cpu().numpy(),
                                   getattr(cpu[0], f).numpy(), rtol=1e-5, atol=1e-6, err_msg=f)
    assert float(card[1]) == pytest.approx(float(cpu[1]), rel=1e-5)
    if method == "pcd":
        for a, b in zip(card[2], cpu[2]):
            assert torch.equal(a.cpu(), b) and set(a.unique().tolist()) <= {0.0, 1.0}


def test_rbm_bf16_headline_step_on_the_card(dev):
    """CD-1 in bf16 at the benchmark's headline shape (batch 4096, 784
    visible, 128 hidden): parameters stay f32 and finite, the loss finite,
    the epoch loop's steps draw on the card's generator."""
    from qbmx_torch.models import rbm

    rng = np.random.default_rng(12)
    x = torch.as_tensor((rng.random((3, 4096, 784)) > 0.5), device=dev).to(torch.bfloat16)
    y = torch.as_tensor(rng.integers(0, 2, (3, 4096)), device=dev)
    params = rbm.init_params(torch.Generator().manual_seed(0), 784, 128, 2, dev)
    epoch = rbm.make_epoch_scan(rbm.make_train_step(2, method="generative",
                                                    compute_dtype=torch.bfloat16))
    new, loss = epoch(params, torch.Generator(device=dev).manual_seed(1), x, y, 0.05)
    for f in rbm.FIELDS:
        leaf = getattr(new, f)
        assert leaf.dtype == torch.float32 and leaf.device.type == "cuda"
        assert bool(torch.isfinite(leaf).all()), f
    assert not torch.equal(new.weights, params.weights) and math.isfinite(float(loss))


# -- the host seams with the model on the card --------------------------------


def test_native_sampler_on_a_cuda_q_returns_on_the_card_equal_to_the_host_call(dev):
    from qbmx_torch.core.rng import draw_seeds
    from qbmx_torch.samplers import native

    Q = random_qubo_batch(np.random.default_rng(0), 5, 6)
    s = api.get_sampler("SA-NATIVE", num_sweeps=100)
    sa_cuda.reset_launch_counts()
    got = s.sample_batch(torch.Generator().manual_seed(4), Q.to(dev), 64)
    assert got.device.type == "cuda" and got.shape == (5, 64, 6)
    assert sum(sa_cuda.launch_counts.values()) == 0  # the host anneals, no kernel
    want = native.sa_sample_batch_native_seeds(
        draw_seeds(torch.Generator().manual_seed(4), 5), Q.numpy(), 64, 100)
    np.testing.assert_array_equal(got.cpu().numpy(), want)


class _CardStub:
    """A structured dimod-style sampler on Chimera C4 that anneals the
    embedded physical QUBO with the port's SA sampler on the card."""

    def __init__(self, dev):
        import types

        from qbmx_torch import embedding

        self.adjacency = embedding.chimera_graph(4)
        self.properties = {"topology": {"type": "chimera", "shape": [4, 4, 4]}}
        self.dev, self.types = dev, types
        self.sampler = api.SASampler(num_sweeps=200)
        self.generator = torch.Generator().manual_seed(0)

    def sample_qubo(self, qdict, num_reads=1, **_):
        variables = sorted({q for ij in qdict for q in ij})
        col = {q: c for c, q in enumerate(variables)}
        Q = torch.zeros((1, len(variables), len(variables)))
        for (i, j), v in qdict.items():
            assert i == j or j in self.adjacency[i], "a coupler off the graph"
            Q[0, col[min(i, j)], col[max(i, j)]] += v
        s = self.sampler.sample_batch(self.generator, Q.to(self.dev), num_reads)[0]
        record = self.types.SimpleNamespace(sample=s.cpu().numpy().astype(np.int8))
        return self.types.SimpleNamespace(record=record, variables=variables, info={})


@pytest.mark.parametrize("copies", [1, 3])
def test_qpu_adapter_with_a_card_stub_returns_on_the_card(dev, copies):
    from qbmx_torch.samplers.qpu import StructuredQPUSampler

    adapter = StructuredQPUSampler(_CardStub(dev), copies=copies)
    Q = torch.as_tensor([[[-2.0, 3.0, 0.0], [0.0, -1.0, 0.5], [0.0, 0.0, 1.0]]], device=dev)
    sa_cuda.reset_launch_counts()
    out = adapter.sample_batch(torch.Generator().manual_seed(1), Q.repeat(2, 1, 1), 30)
    assert out.device.type == "cuda" and out.shape == (2, 30, 3)
    assert sa_cuda.launch_counts["sa_metropolis"] == 2  # one stub call a problem
    # the ground state [1, 0, 0] (E = -2, the next -1) is the reads' most frequent state
    states, counts = torch.unique(out[0], dim=0, return_counts=True)
    assert states[counts.argmax()].tolist() == [1.0, 0.0, 0.0]
    assert adapter.embedding_searches == 1


# -- the mesh on the card ----------------------------------------------------------


@pytest.mark.parametrize("family,kernel", [("dqbm", "sa_metropolis"),
                                           ("cdqbm_a", "anneal_wide_sparse")])
def test_mesh_world_of_one_under_nccl_is_the_single_step(dev, tmp_path, family, kernel):
    """A world of one under NCCL: the sharded step launches its kernel once
    (K1 at the flat model, K4's sparse shared path at CDQBM (a)'s 717
    variables) and equals the
    single model's step fed ``fold_in(generator, 0, 0)`` bit for bit."""
    import copy
    import datetime

    import torch.distributed as dist

    from qbmx_torch.core.rng import fold_in
    from qbmx_torch.models.base import tree_leaves
    from qbmx_torch.models.cdqbm import CDQBM
    from qbmx_torch.models.dqbm import DiscQBM
    from qbmx_torch.parallel.mesh import make_mesh, shard_model
    from qbmx_torch.samplers import launches

    rng = np.random.default_rng(3)
    if family == "dqbm":
        base = DiscQBM(dim_input=20, n_hidden_nodes=5, sample_count=64, anneal_steps=50,
                       device=dev)
        x = torch.as_tensor(rng.random((12, 20), dtype=np.float32), device=dev)
    else:
        base = CDQBM(pooling_size=4, pooling_type="probabilistic", sequential_layer_sizes=[4],
                     hidden_bias_type="shared", sample_count=16, anneal=10, beta_eff=5.0,
                     device=dev)
        x = torch.as_tensor(rng.random((4, 28, 28), dtype=np.float32), device=dev)
    y = torch.as_tensor(np.arange(x.shape[0]) % 2, device=dev)
    mask = torch.ones(x.shape[0], device=dev)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rendezvous", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        sharded = shard_model(copy.deepcopy(base), make_mesh(dp=1, device=dev))
        launches.reset()
        n1, e1 = sharded._step(x, y, mask, 0.1)
        torch.cuda.synchronize()
        assert launches.counts() == {kernel: 1}
    finally:
        dist.destroy_process_group()
    single = copy.deepcopy(base)
    single.generator = fold_in(single.generator, 0, 0)
    n2, e2 = single._step(x, y, mask, 0.1)
    assert torch.equal(n1, n2) and torch.equal(e1, e2)
    for a, b in zip(tree_leaves(sharded.params), tree_leaves(single.params)):
        assert torch.equal(a, b)


def test_mesh_two_ranks_on_one_card_over_gloo(dev, tmp_path):
    """Two spawned ranks on ``cuda:0`` over gloo (NCCL refuses two ranks on
    one card): the flagship step sharded over dp=2 within ``PAIR_ATOL`` of
    the unsharded step, where the rank's step without the all-reduce lies
    farther; K1 launched once a step on each rank; the 10-seed sweep over
    dp=2 launching K1 once a step and once for validation on each rank,
    rank 0 alone writing its pickles; the ranks' launches of the same local
    groups from the sweep's stream draw different numbers, and leave the
    sweep's generator in one state."""
    from qbmx_torch.parallel import dryrun

    ranks = dryrun.spawn(dryrun.flagship_pair, 2, "gloo", ("cuda:0", str(tmp_path)),
                         timeout=300.0)
    for r in ranks:
        assert r["step_launches"] == {"sa_metropolis": 1}
        assert r["max_diff"] <= dryrun.PAIR_ATOL and r["nll_diff"] <= dryrun.PAIR_NLL_ATOL
        assert r["control_diff"] > dryrun.PAIR_ATOL
        assert r["sweep_launches"] == {"sa_metropolis": 3}
        assert len(r["files"]) == (10 if r["rank"] == 0 else 0)
    assert not np.array_equal(ranks[0]["probe"], ranks[1]["probe"])
    assert ranks[0]["generator_state"] == ranks[1]["generator_state"]


# -- the global-field layouts: K4 past n = 3368, K5 past its shared paths ------


@pytest.mark.parametrize("rule", [0, 1, 2, 4])
@pytest.mark.parametrize("n", [301, 717])
def test_wide_global_layout_equals_the_shared_layout(dev, n, rule):
    """K4's global-field layout forced at shared widths: the same samples,
    final fields and counters as the shared layout, bit for bit, past a
    refresh (S = 70), with spare chains in the last block."""
    G, B, R, S = 2, 3, 20, 70
    rng = np.random.default_rng(n + rule)
    Q, h_extra = _structured(rng, G, B, n, dev)
    hv = _variates(rng, (G, B), n, R, S, dev)
    J, h, hot, logr = _structured_form(Q, h_extra, S, rule, 1.0)
    res = []
    for layout in (wide_cuda.SHARED, wide_cuda.GLOBAL):
        fields = torch.empty((G, B, R, n), device=dev)
        flips = torch.zeros(2, dtype=torch.int64, device=dev)
        out = wide_cuda.launch(J, h, hot, logr, R, S, rule, host_variates=hv, fields_out=fields,
                               flips=flips,
                               geometry=wide_cuda.WideGeometry.of(G, B, R, n, 7, layout))
        torch.cuda.synchronize()
        res.append((out, fields, flips))
    for a, b in zip(*res):
        assert torch.equal(a, b)


@pytest.mark.parametrize("rule", list(RULES))
@pytest.mark.parametrize("n", [3369, 4096, 8192])
def test_wide_global_layout_matches_plain(dev, n, rule):
    """Past the shared layout (one, two and three column chunks a row), the
    sampler's wrappers launch K4's global-field layout once, within the 1%
    chain bound of plain (256 chains)."""
    G, B, R, S = 1, 2, 128, 2
    rng = np.random.default_rng(n + len(rule))
    Q, h_extra = _structured(rng, G, B, n, dev)
    hv = _variates(rng, (G, B), n, R, S, dev)
    wide_cuda.reset_launch_counts()
    got = _kernel_groups(rule, Q, h_extra, R, S, host_variates=hv)
    torch.cuda.synchronize()
    assert wide_cuda.launch_counts == {"anneal_wide": 0, "anneal_wide_sparse": 0,
                                       "anneal_wide_global": 1, "anneal_wide_global_sparse": 0}
    assert _differ(got, _plain_groups(rule, Q, h_extra, R, S, hv)) <= MAX_DIFF_FRAC


@pytest.mark.parametrize("G,B,n,M,R,S", [(2, 2, 300, 8, 8, 70), (1, 2, 717, 12, 4, 10)])
def test_pt_global_path_equals_the_dense_path(dev, G, B, n, M, R, S):
    """K5's global path forced where the dense path runs: the same samples,
    states, fields, energies and counters bit for bit under host variates,
    and the same samples on its own Philox draws."""
    rng = np.random.default_rng(n + M)
    Q, h_extra = _structured(rng, G, B, n, dev)
    J, h, betas, dbeta = pt_wide_cuda.structured_form(Q, h_extra, M)
    hv = _pt_variates(rng, G * B, M, n, R, S, dev)
    res = []
    for path in (pt_wide_cuda.DENSE, pt_wide_cuda.GLOBAL):
        st = torch.empty((G * B * M, R, n), device=dev)
        fo = torch.empty_like(st)
        eo = torch.empty((G * B * M, R), device=dev)
        fl = torch.zeros(2, dtype=torch.int64, device=dev)
        out = pt_wide_cuda.launch(J, h, betas, dbeta, R, S, host_variates=hv, states_out=st,
                                  fields_out=fo, energy_out=eo, flips=fl, path=path)
        torch.cuda.synchronize()
        res.append((out, st, fo, eo, fl))
    for a, b in zip(*res):
        assert torch.equal(a, b)
    a, b = (pt_wide_cuda.launch(J, h, betas, dbeta, R, S, path=p,
                                generator=torch.Generator().manual_seed(5))
            for p in (pt_wide_cuda.DENSE, pt_wide_cuda.GLOBAL))
    assert torch.equal(a, b)


def _sparse_structured(rng, G, B, n, dev, density=0.005):
    """G QUBOs whose couplings are ``density`` nonzeros (under the density
    rule's 1% with the rest), and the restricted flat model's pattern
    besides: variable 0 (the output) coupled to every other, as ``qbm_main
    -hn 3400``'s unclamped group."""
    Q = random_qubo_batch(rng, G, n).to(dev)
    keep = torch.as_tensor(rng.random((G, n, n)) < density, device=dev)
    keep[:, 0, :] = True
    Q = torch.where(keep | torch.eye(n, dtype=torch.bool, device=dev), Q, torch.zeros_like(Q))
    return Q, torch.as_tensor(rng.normal(size=(G, B, n)).astype(np.float32), device=dev)


@pytest.mark.parametrize("rule", [0, 1, 2, 4])
@pytest.mark.parametrize("n,qubos", [(301, "dense"), (301, "sparse"), (717, "CDQBM (a)"),
                                     (3401, "sparse")])
def test_wide_global_sparse_pass_equals_the_dense_pass(dev, n, qubos, rule):
    """K4's global-field layout with its sparse pass forced and with its
    dense pass forced: the same samples, final fields and counters bit for
    bit, past a refresh, on dense and sparse QUBOs; at shared widths also
    the shared layout's; the launches counted by pass."""
    G, B, R, S = 2, 3, 20, 70 if n < 3000 else 3
    rng = np.random.default_rng(n + rule + 7)
    if qubos == "dense":
        Q, h_extra = _structured(rng, G, B, n, dev)
    elif qubos == "sparse":
        Q, h_extra = _sparse_structured(rng, G, B, n, dev)
    else:
        Q, h_extra = cdqbm_a_qubos(B, dev)
    hv = _variates(rng, (G, B), n, R, S, dev)
    J, h, hot, logr = _structured_form(Q, h_extra, S, rule, 1.0)
    runs = [(wide_cuda.GLOBAL, "dense"), (wide_cuda.GLOBAL, "sparse")]
    if n <= wide_cuda.max_n():
        runs.append((wide_cuda.SHARED, "dense"))
    res = []
    for layout, field_pass in runs:
        fields = torch.empty((G, B, R, n), device=dev)
        flips = torch.zeros(2, dtype=torch.int64, device=dev)
        wide_cuda.reset_launch_counts()
        out = wide_cuda.launch(J, h, hot, logr, R, S, rule, host_variates=hv, fields_out=fields,
                               flips=flips, field_pass=field_pass,
                               geometry=wide_cuda.WideGeometry.of(G, B, R, n, 7, layout))
        torch.cuda.synchronize()
        key = {(wide_cuda.GLOBAL, "dense"): "anneal_wide_global",
               (wide_cuda.GLOBAL, "sparse"): "anneal_wide_global_sparse",
               (wide_cuda.SHARED, "dense"): "anneal_wide"}[layout, field_pass]
        assert wide_cuda.launch_counts[key] == 1 and sum(wide_cuda.launch_counts.values()) == 1
        res.append((out, fields, flips))
    for other in res[1:]:
        for a, b in zip(res[0], other):
            assert torch.equal(a, b)


@pytest.mark.parametrize("G,B,n,M,R,S,qubos", [(2, 2, 300, 8, 8, 70, "sparse"),
                                               (1, 2, 717, 12, 4, 10, "dense"),
                                               (2, 2, 717, 8, 4, 10, "CDQBM (a)"),
                                               (2, 1, 3401, 8, 8, 3, "sparse")])
def test_pt_global_sparse_pass_equals_the_dense_pass(dev, G, B, n, M, R, S, qubos):
    """K5's global path with its sparse pass forced and with its dense pass
    forced: the same samples, states, fields, energies and counters bit for
    bit under host variates; where the dense path takes the shape, its
    too."""
    rng = np.random.default_rng(n + M + 3)
    if qubos == "dense":
        Q, h_extra = _structured(rng, G, B, n, dev)
    elif qubos == "sparse":
        Q, h_extra = _sparse_structured(rng, G, B, n, dev)
    else:
        Q, h_extra = cdqbm_a_qubos(B, dev)
    J, h, betas, dbeta = pt_wide_cuda.structured_form(Q, h_extra, M)
    hv = _pt_variates(rng, G * B, M, n, R, S, dev)
    runs = [(pt_wide_cuda.GLOBAL, "dense"), (pt_wide_cuda.GLOBAL, "sparse")]
    if n <= pt_wide_cuda.max_n():
        runs.append((pt_wide_cuda.DENSE, None))
    res = []
    for path, field_pass in runs:
        st = torch.empty((G * B * M, R, n), device=dev)
        fo = torch.empty_like(st)
        eo = torch.empty((G * B * M, R), device=dev)
        fl = torch.zeros(2, dtype=torch.int64, device=dev)
        pt_wide_cuda.reset_launch_counts()
        out = pt_wide_cuda.launch(J, h, betas, dbeta, R, S, host_variates=hv, states_out=st,
                                  fields_out=fo, energy_out=eo, flips=fl, path=path,
                                  field_pass=field_pass)
        torch.cuda.synchronize()
        key = {"dense": "pt_wide_global", "sparse": "pt_wide_global_sparse",
               None: "pt_wide"}[field_pass]
        assert pt_wide_cuda.launch_counts[key] == 1
        assert sum(pt_wide_cuda.launch_counts.values()) == 1
        res.append((out, st, fo, eo, fl))
    for other in res[1:]:
        for a, b in zip(res[0], other):
            assert torch.equal(a, b)


def test_the_density_rule_picks_the_pass(dev):
    """Through the sampler's wrappers past the shared layouts: a sparse
    J_g (``_sparse_structured``: 0.5% and the output's row) on the sparse
    pass, a dense one on the dense pass, for K4 and K5, each within the 1%
    chain bound of plain."""
    G, B, R, S, n = 1, 2, 64, 2, 3401
    for qubos, sparse in (("sparse", True), ("dense", False)):
        rng = np.random.default_rng(11 if sparse else 12)
        Q, h_extra = (_sparse_structured if sparse else _structured)(rng, G, B, n, dev)
        J = split_qubo(Q)[1]
        assert wide_cuda.sparse_pass(pt_wide_cuda.row_nnz(J), n) == sparse
        hv = _variates(rng, (G, B), n, R, S, dev)
        wide_cuda.reset_launch_counts()
        got = _kernel_groups("metropolis", Q, h_extra, R, S, host_variates=hv)
        torch.cuda.synchronize()
        key = "anneal_wide_global_sparse" if sparse else "anneal_wide_global"
        assert wide_cuda.launch_counts[key] == 1 and sum(wide_cuda.launch_counts.values()) == 1
        assert _differ(got, _plain_groups("metropolis", Q, h_extra, R, S, hv)) <= MAX_DIFF_FRAC
        M = 4
        hv = _pt_variates(rng, G * B, M, n, R, S, dev)
        pt_wide_cuda.reset_launch_counts()
        got = pt_wide_cuda.pt_sample_groups(Q, h_extra, R, S, num_replicas=M, host_variates=hv)
        torch.cuda.synchronize()
        key = "pt_wide_global_sparse" if sparse else "pt_wide_global"
        assert pt_wide_cuda.launch_counts[key] == 1
        assert sum(pt_wide_cuda.launch_counts.values()) == 1
        want = tempering.pt_sample_batch_plain(api.densify_groups(Q, h_extra), R, S,
                                               num_replicas=M, host_variates=hv)
        assert _differ(got, want.reshape(G, B, R, n)) <= MAX_DIFF_FRAC


@pytest.mark.parametrize("G,B,n,M,R,S", [
    (2, 2, 3401, 8, 64, 4),   # qbm_main -hn 3400's PT call, cut
    (1, 1, 3000, 24, 256, 4),  # past a cluster of the dense path's 2-rung blocks
    (1, 1, 300, 300, 256, 6),  # past a cluster of 32-warp blocks
    (1, 1, 4100, 3, 256, 3),   # past the 10-bit Philox variable block
])
def test_pt_global_path_matches_plain(dev, G, B, n, M, R, S):
    rng = np.random.default_rng(n + M + 1)
    Q, h_extra = _structured(rng, G, B, n, dev)
    hv = _pt_variates(rng, G * B, M, n, R, S, dev)
    pt_wide_cuda.reset_launch_counts()
    got = pt_wide_cuda.pt_sample_groups(Q, h_extra, R, S, num_replicas=M, host_variates=hv)
    torch.cuda.synchronize()
    assert pt_wide_cuda.launch_counts == {"pt_wide": 0, "pt_wide_sparse": 0, "pt_wide_global": 1,
                                          "pt_wide_global_sparse": 0}
    want = tempering.pt_sample_batch_plain(api.densify_groups(Q, h_extra), R, S, num_replicas=M,
                                           host_variates=hv).reshape(G, B, R, n)
    assert _differ(got, want) <= MAX_DIFF_FRAC


def test_pt_global_path_draws_its_written_out_philox_streams(dev):
    """At n = 4100 the global path's Philox variable block takes 11 bits
    (``pt_wide_cuda.var_shift``): ``pt_philox_variates`` writes them out."""
    G, B, n, M, R, S = 1, 1, 4100, 2, 2, 2
    Q, _ = _structured(np.random.default_rng(9), G, B, n, dev)
    J, h, betas, dbeta = pt_wide_cuda.structured_form(Q, torch.zeros((G, B, n), device=dev), M)
    seed = draw_seed(torch.Generator().manual_seed(3))
    got = pt_wide_cuda.launch(J, h, betas, dbeta, R, S,
                              generator=torch.Generator().manual_seed(3))
    hv = tuple(torch.as_tensor(a, device=dev) for a in sa_torch.pt_philox_variates(
        seed, G * B, M, R, n, S, var_shift=pt_wide_cuda.var_shift(n)))
    assert pt_wide_cuda.var_shift(n) == 11
    assert torch.equal(got, pt_wide_cuda.launch(J, h, betas, dbeta, R, S, host_variates=hv))


# -- the user scripts: the breastmnist search and the exact studies ------------


@pytest.mark.parametrize("cfg,kernel", [
    ({"solver": "SA", "h": 5, "lr": 0.307, "sc": 100, "sweeps": 100, "e": 1}, "sa_metropolis"),
    ({"solver": "BMS", "h": 8, "lr": 0.453, "sc": 100, "sweeps": 100, "e": 1}, "sa_heatbath"),
    ({"solver": "PT", "h": 5, "lr": 0.453, "sc": 100, "sweeps": 128, "e": 1}, "pt_heatbath"),
])
def test_bms_search_config_launches_its_kernel_once_a_step(dev, tmp_path, cfg, kernel):
    """``bms_hyper_search.run_config`` at breastmnist's shapes (546 train
    and 156 test images of 784 inputs, bs 20: 28 steps), 3 seeds: one launch
    of the solver's kernel a step and one for validation, nothing else."""
    from qbmx_torch.cli import bms_hyper_search
    from qbmx_torch.samplers import launches

    r = np.random.default_rng(3)
    split = lambda n: (r.random((n, 784), dtype=np.float32), (r.random(n) < 0.27).astype(int))
    seeds = (list(bms_hyper_search.DEFAULT_SEEDS) + bms_hyper_search.EXTRA_SEEDS)[:3]
    launches.reset()
    rec = bms_hyper_search.run_config((split(546), split(156)), cfg, seeds,
                                      tmp_path / "search.jsonl", device="cuda")
    torch.cuda.synchronize()
    assert launches.counts() == {kernel: math.ceil(546 / 20) + 1}
    assert rec["n_seeds"] == 3 and all(0 <= p["acc"] <= 1 for p in rec["per_seed"])


def test_exact_study_card_matches_cpu(dev):
    """A bars variant of ``cdqbm_exact_study`` (probabilistic pooling, a
    learned penalty, signed inputs), 20 Adam steps through the enumeration
    on the card and on the CPU from the same inputs: p(y=1|x) within 1e-4."""
    from qbmx_torch.cli import cdqbm_exact_study as study
    from qbmx_torch.cli import exact_harness as xh

    X, Y = study.make_bars(np.random.default_rng(0))
    X = X * 2.0 - 1.0
    kw = dict(kernel_size=4, pooling_size=2, pooling_type="probabilistic",
              sequential_layer_sizes=[2], hidden_bias_type="shared", learn_penalty=True)
    p = {}
    for d in ("cuda", "cpu"):
        m = study.make_model(X.shape[1:], d, **kw)
        params, _ = study.train_exact(m, X, Y, steps=20)
        p[d] = xh.predict_p1(lambda q, x: study.exact_p1(m, q, x), params, X)
    assert np.abs(p["cuda"] - p["cpu"]).max() <= 1e-4


# -- K4's sparse shared path (qbmx_torch/csrc/anneal_wide_sparse.cu) -------------


def _sparse_qubos(rng, G, B, n, dev):
    """Sparse QUBOs at width n: CDQBM (a)'s step QUBOs at 717 (G = 2), the
    restricted flat model's at 301 (``qbm_main -hn 300 -r True``, G = 2),
    ``_sparse_structured``'s elsewhere."""
    from qbmx_torch.cli.compare_kernels import flat_step_qubos

    if n == 717:
        return cdqbm_a_qubos(B, dev)
    if n == 301:
        return flat_step_qubos(300, B, dev)
    return _sparse_structured(rng, G, B, n, dev)


@pytest.mark.parametrize("rule", [0, 1, 2, 4])
@pytest.mark.parametrize("n", [242, 301, 717, 1056])
def test_wide_sparse_path_equals_the_dense_path(dev, n, rule):
    """K4's shared layout with its sparse path forced and with its dense
    path forced: the same samples, final fields and counters bit for bit,
    past a refresh (S = 70), 7 chains a block with spare chains in the
    last block, under host variates and on the kernels' own Philox draws;
    each launch counted by path."""
    G, B, R, S = 2, 3, 20, 70
    rng = np.random.default_rng(n + rule + 11)
    Q, h_extra = _sparse_qubos(rng, G, B, n, dev)
    hv = _variates(rng, (G, B), n, R, S, dev)
    J, h, hot, logr = _structured_form(Q, h_extra, S, rule, 1.0)
    geo = wide_cuda.WideGeometry.of(G, B, R, n, 7)
    res = []
    for path in (wide_cuda.DENSE, wide_cuda.SPARSE):
        fields = torch.empty((G, B, R, n), device=dev)
        flips = torch.zeros(2, dtype=torch.int64, device=dev)
        wide_cuda.reset_launch_counts()
        out = wide_cuda.launch(J, h, hot, logr, R, S, rule, host_variates=hv, fields_out=fields,
                               flips=flips, field_pass=path, geometry=geo)
        philox = wide_cuda.launch(J, h, hot, logr, R, S, rule, field_pass=path, geometry=geo,
                                  generator=torch.Generator().manual_seed(n))
        torch.cuda.synchronize()
        key = "anneal_wide" if path == wide_cuda.DENSE else "anneal_wide_sparse"
        assert wide_cuda.launch_counts[key] == 2 and sum(wide_cuda.launch_counts.values()) == 2
        res.append((out, fields, flips, philox))
    assert res[0][2][0] > 0
    for a, b in zip(*res):
        assert torch.equal(a, b)


@pytest.mark.parametrize("rule", [0, 1, 2, 4])
def test_wide_sparse_commit_rounds_follow_each_change(dev, rule):
    """A banded J_g (each variable coupled to the three on either side), so
    that nearly every change moves the field of a later unit of its batch,
    at a hot schedule (many changes, so many commit rounds a batch): the
    sparse path, whose commit sweeps decide a batch's units at once and
    decide again after each change, equals the dense path, one unit at a
    time, bit for bit in samples, final fields and counters."""
    G, B, R, S, n = 2, 2, 40, 70, 301
    rng = np.random.default_rng(rule + 23)
    idx = torch.arange(n, device=dev)
    band = (idx[:, None] - idx[None, :]).abs() <= 3
    Q = random_qubo_batch(rng, G, n, scale=2.0).to(dev) * band
    h_extra = torch.as_tensor(rng.normal(size=(G, B, n)).astype(np.float32), device=dev)
    hv = _variates(rng, (G, B), n, R, S, dev)
    J, h, hot, logr = _structured_form(Q, h_extra, S, rule, 0.3)
    res = []
    for path in (wide_cuda.DENSE, wide_cuda.SPARSE):
        fields = torch.empty((G, B, R, n), device=dev)
        flips = torch.zeros(2, dtype=torch.int64, device=dev)
        out = wide_cuda.launch(J, h, hot, logr, R, S, rule, host_variates=hv, fields_out=fields,
                               flips=flips, field_pass=path)
        torch.cuda.synchronize()
        res.append((out, fields, flips))
    assert res[0][2][0] > G * B * R * S * n // 50  # many changes, so many rounds, a batch
    for a, b in zip(*res):
        assert torch.equal(a, b)


@pytest.mark.parametrize("solver", ["SA", "BMS"])
def test_wide_dense_couplings_skip_the_count(dev, solver, monkeypatch):
    """The flat model with a dense ``w_hh`` (``qbm_main -hn 300 -r False``)
    through its own sampler, which carries ``dense_couplings``: K4's dense
    shared path, launched once, equal bit for bit to the rule's own choice
    without the hint, and without counting J's nonzeros (the count, and the
    host sync it costs, would raise here)."""
    from qbmx_torch.cli.compare_kernels import flat_step_qubos
    from qbmx_torch.models.dqbm import DiscQBM
    from qbmx_torch.samplers import pt_wide_cuda

    B, R, S = 4, 20, 10
    Q, h_extra = flat_step_qubos(300, B, dev, restricted=False)
    m = DiscQBM(dim_input=784, n_hidden_nodes=300, solver=solver, anneal_steps=S,
                restricted=False, device=dev)
    assert m.sampler.dense_couplings
    hint = lambda: m.sampler.sample_groups(torch.Generator().manual_seed(3), Q, h_extra, R)
    rule = dataclasses.replace(m.sampler, dense_couplings=False)
    want = rule.sample_groups(torch.Generator().manual_seed(3), Q, h_extra, R)
    torch.cuda.synchronize()
    wide_cuda.reset_launch_counts()

    def no_count(J):
        raise AssertionError("J's nonzeros were counted")

    monkeypatch.setattr(pt_wide_cuda, "row_nnz", no_count)
    got = hint()
    torch.cuda.synchronize()
    assert wide_cuda.launch_counts["anneal_wide"] == 1 and sum(wide_cuda.launch_counts.values()) == 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("rule", list(RULES))
@pytest.mark.parametrize("n", [301, 717])
def test_wide_sparse_path_matches_plain(dev, n, rule):
    """Through the sampler's wrappers on the step QUBOs of the restricted
    flat model (n = 301) and of CDQBM (a) (n = 717): the rule's sparse path,
    launched once and nothing else, within the 1% chain bound of plain
    under host variates, past a refresh."""
    G, B, R, S = 2, 4, 50, 70
    rng = np.random.default_rng(n + len(rule) + 5)
    Q, h_extra = _sparse_qubos(rng, G, B, n, dev)
    hv = _variates(rng, (G, B), n, R, S, dev)
    for mod in (sa_cuda, gibbs_cuda, wide_cuda):
        mod.reset_launch_counts()
    got = _kernel_groups(rule, Q, h_extra, R, S, host_variates=hv)
    torch.cuda.synchronize()
    assert wide_cuda.launch_counts["anneal_wide_sparse"] == 1
    assert sum(wide_cuda.launch_counts.values()) == 1
    assert sa_cuda.launch_counts["sa_metropolis"] == gibbs_cuda.launch_counts["sa_heatbath"] == 0
    assert _differ(got, _plain_groups(rule, Q, h_extra, R, S, hv)) <= MAX_DIFF_FRAC


@pytest.mark.parametrize("rule", list(RULES))
def test_wide_sparse_path_on_its_philox_draws(dev, rule):
    """The sparse path draws K1's and K2's streams: the plain version on
    those draws written out (``sa_torch.philox_variates``)."""
    G, B, R, S, n = 2, 2, 32, 3, 717
    Q, h_extra = cdqbm_a_qubos(B, dev)
    seed = draw_seed(torch.Generator().manual_seed(15))
    wide_cuda.reset_launch_counts()
    got = _kernel_groups(rule, Q, h_extra, R, S, generator=torch.Generator().manual_seed(15))
    assert wide_cuda.launch_counts["anneal_wide_sparse"] == 1
    hv = tuple(torch.as_tensor(a, device=dev) for a in sa_torch.philox_variates(seed, G, B, R, n, S))
    assert _differ(got, _plain_groups(rule, Q, h_extra, R, S, hv)) <= MAX_DIFF_FRAC


@pytest.mark.parametrize("n", [2, 5, 8])
def test_forced_wide_sparse_path_matches_oracle(dev, n):
    """The sparse path forced at narrow widths on its own Philox draws: the
    oracle bounds of K1 (Metropolis, cold beta) and K2 (pair heat-bath,
    beta 1)."""
    Q = random_qubo_batch(np.random.default_rng(0), 1, n, scale=0.5).to(dev)
    wide_cuda.reset_launch_counts()
    s = _forced_wide(Q, 512, 200, wide_cuda.METROPOLIS, torch.Generator().manual_seed(n),
                     field_pass=wide_cuda.SPARSE)
    _, cold = default_beta_range(Q[0])
    _, _, marg, _ = exact_boltzmann(Q[0], beta=float(cold))
    assert torch.allclose(s[0].mean(0), marg, atol=0.12)
    Q = torch.as_tensor(np.triu(np.random.default_rng(11).uniform(-1, 1, (1, n, n)))
                        .astype(np.float32), device=dev)
    s = _forced_wide(Q, 2048, 64, wide_cuda.PAIR, torch.Generator().manual_seed(4),
                     field_pass=wide_cuda.SPARSE)[0]
    _, _, marg, pair_m = exact_boltzmann(Q[0], beta=1.0)
    assert torch.allclose(s.mean(0), marg, atol=0.05)
    assert torch.allclose(s.T @ s / 2048, pair_m, atol=0.07)
    assert wide_cuda.launch_counts["anneal_wide_sparse"] == 2
    assert sum(wide_cuda.launch_counts.values()) == 2


def test_forced_sparse_path_refuses_lists_that_do_not_fit(dev):
    """A dense J_g's row lists exceed a block: forcing the sparse path
    raises, and nothing is launched in its place."""
    G, B, R, S, n = 1, 1, 4, 2, 717
    Q, h_extra = _structured(np.random.default_rng(9), G, B, n, dev)
    J, h, hot, logr = _structured_form(Q, h_extra, S)
    wide_cuda.reset_launch_counts()
    with pytest.raises(ValueError, match="do not fit"):
        wide_cuda.launch(J, h, hot, logr, R, S, wide_cuda.METROPOLIS,
                         field_pass=wide_cuda.SPARSE)
    assert sum(wide_cuda.launch_counts.values()) == 0
