"""The plain references against exact enumeration at n ≤ 6, and the
waves of a sweep against the ordered sweep they stand for."""

from __future__ import annotations

import itertools
import math

import pytest
import torch

from benchmark.reference import anneal, dqbm
from benchmark.reference.precision import FP32, TF32, round_tf32


def _states(n):
    return torch.tensor(list(itertools.product((0.0, 1.0), repeat=n)))


def _exact(h, U, beta=1.0):
    """Boltzmann probabilities of every state of one problem, and the states."""
    S = _states(h.shape[-1])
    E = S @ h + ((S @ U) * S).sum(-1)
    w = torch.exp(-beta * (E - E.min()).double())
    return w / w.sum(), S, E


def _problem(n, seed):
    g = torch.Generator().manual_seed(seed)
    h = torch.rand(n, generator=g) * 2 - 1
    U = torch.triu(torch.rand(n, n, generator=g) * 2 - 1, 1)
    return h, U


@pytest.mark.parametrize("n", [3, 5, 6])
def test_energies_against_enumeration(n):
    h, U = _problem(n, n)
    _, S, E = _exact(h, U)
    got = anneal.energies(h[None, None], anneal.symmetric(U[None]), S[None, None])[0, 0]
    assert torch.allclose(got, E.double(), atol=1e-6)


@pytest.mark.parametrize("n", [4, 6])
def test_tempering_samples_boltzmann(n):
    h, U = _problem(n, 10 + n)
    p, S, _ = _exact(h, U)
    g = torch.Generator().manual_seed(1)
    s = anneal.anneal_pt(h[None, None], U[None], 4000, 60, 8, g)[0, 0]
    marg = s.mean(0).double()
    want = (p[:, None] * S.double()).sum(0)
    assert torch.allclose(marg, want, atol=0.035)


@pytest.mark.parametrize("n", [4, 6])
def test_annealing_ends_in_the_ground_state(n):
    h, U = _problem(n, 20 + n)
    _, S, E = _exact(h, U)
    g = torch.Generator().manual_seed(2)
    s = anneal.anneal_sa(h[None, None], U[None], 500, 200, g)[0, 0]
    ground = S[torch.argmin(E)]
    assert (s == ground).all(-1).double().mean() > 0.9


def _ordered_sa(h, U, reads, sweeps, g):
    """The ordered sweep, unit by unit, drawing as ``anneal_sa`` draws."""
    G, B, n = h.shape
    J = anneal.symmetric(U)
    hot, cold = anneal.beta_range(h, J)
    logr = torch.log(cold / hot)
    s = (torch.rand((G, B, reads, n), generator=g) < 0.5).float()
    for t in range(sweeps):
        beta = hot * torch.exp(logr * (t * (1.0 / (sweeps - 1))))
        thr = -torch.log(torch.rand((G, B, reads, n), generator=g)) / beta[:, :, None, None]
        for i in range(n):
            f = h[:, :, None, i] + torch.matmul(s, J[:, None, :, i, None])[..., 0]
            si = s[..., i]
            s[..., i] = torch.where((1 - 2 * si) * f < thr[..., i], 1 - si, si)
    return s


def test_waves_equal_the_ordered_sweep():
    # sparse couplings on a grid of 1/4, so every field sums exactly
    n = 9
    g = torch.Generator().manual_seed(3)
    h = torch.randint(-4, 5, (2, 3, n), generator=g).float() / 4
    U = torch.triu(torch.randint(-4, 5, (2, n, n), generator=g).float() / 4, 1)
    U *= torch.triu(torch.rand(n, n, generator=g) < 0.3, 1)
    assert len(anneal.waves(U)) < n
    a = anneal.anneal_sa(h, U, 7, 12, torch.Generator().manual_seed(9))
    b = _ordered_sa(h, U, 7, 12, torch.Generator().manual_seed(9))
    assert torch.equal(a, b)


def test_dqbm_unclamped_qubo_against_its_energy():
    # the unclamped QUBO's energy of (y, h) is the model's, term by term
    model = {"dim_input": 4, "n_hidden_nodes": 3, "restricted": False, "beta_eff": 2.0}
    g = torch.Generator().manual_seed(4)
    p = {name: torch.rand((1,) + shape, generator=g) * 2 - 1
         for name, shape, _ in dqbm.leaf_specs(model)}
    p["w_hh"], p["w_oo"] = torch.triu(p["w_hh"], 1), torch.zeros_like(p["w_oo"])
    x = torch.rand(1, 4, generator=g)
    h, U = dqbm.predict_problems(p, x, model)
    for state in _states(4):
        y, hid = state[:1], state[1:]
        e = (p["b_o"][0] @ y + (x[0] @ p["w_vo"][0]) @ y + p["b_h"][0] @ hid
             + (x[0] @ p["w_vh"][0, 1:]) @ hid + y @ p["w_vh"][0, :1] @ hid
             + hid @ torch.triu(p["w_hh"][0], 1) @ hid) / 2.0
        got = h[0, 0] @ state + state @ U[0] @ state
        assert math.isclose(float(got), float(e), abs_tol=1e-5)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-11, -3.0e-5])
    r = round_tf32(x)
    assert r[0] == 1.0 and r[1] == 1.0 and r[2] == 1.0 + 2**-9
    assert abs(float(r[3]) + 3.0e-5) <= 3.0e-5 * 2**-11
    a = torch.rand(64, 64)
    assert not torch.equal(TF32.matmul(a, a), FP32.matmul(a, a))
