"""The plain PyTorch Metropolis anneal (qbmx_torch.samplers.sa_torch) and the
sampler registry against qbmx.

Under host variates the plain version must reproduce the TPU kernels run in
interpret mode (``lane_sample_groups`` and ``sa_sample_batch_pallas`` with
``debug_randoms``) and the XLA sweep ``sa_jax._metropolis_sweep``
EXACTLY: the standard tests/test_sa_lane.py holds the TPU kernel to.  The
generator path is held against the exact oracle with the bounds of
tests/test_samplers.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qbmx.core.qubo import default_beta_range as j_default_beta_range
from qbmx.samplers import api as japi
from qbmx.samplers.sa_jax import _metropolis_sweep
from qbmx.samplers.sa_lane import lane_geometry, lane_sample_groups
from qbmx.samplers.sa_pallas import sa_sample_batch_pallas
from qbmx_torch.core.qubo import default_beta_range, qubo_energies, random_qubo_batch
from qbmx_torch.samplers import api, kernel_call, sa_cuda, sa_torch, wide_cuda
from qbmx_torch.samplers.exact import enumerate_states, exact_boltzmann

torch.set_num_threads(1)


def _structured(seed, G, B, n, R, S):
    rng = np.random.default_rng(seed)
    Qg = np.triu(rng.uniform(-1, 1, (G, n, n))).astype(np.float32)
    h_extra = rng.normal(size=(G, B, n)).astype(np.float32)
    init01 = (rng.random((G, B, R, n)) < 0.5).astype(np.float32)
    u = np.clip(rng.random((S, G, B, n, R)).astype(np.float32), 1e-6, 1 - 1e-6)
    return Qg, h_extra, init01, u


def _dense(seed, B, n, R, S):
    rng = np.random.default_rng(seed)
    Q = np.triu(rng.uniform(-2, 2, (B, n, n))).astype(np.float32)
    init01 = (rng.random((B, R, n)) < 0.5).astype(np.float32)
    u = np.clip(rng.random((S, B, n, R)).astype(np.float32), 1e-6, 1 - 1e-6)
    return Q, init01, u


T = torch.as_tensor


@pytest.mark.parametrize("G,B,n,R,S", [
    (2, 5, 11, 7, 6),   # tail n % 8
    (3, 2, 21, 5, 5),   # three 8-blocks with a tail
    (1, 1, 3, 1, 3),    # minimal
])
@pytest.mark.parametrize("schedule", ["explicit", "default"])
def test_groups_match_lane_kernel(G, B, n, R, S, schedule):
    Qg, h_extra, init01, u = _structured(G * 100 + n, G, B, n, R, S)
    betas = {}
    if schedule == "explicit":
        betas = dict(beta_hot=np.full((G, B), 0.25, np.float32),
                     beta_cold=np.full((G, B), 2.0, np.float32))
    want = lane_sample_groups(
        jax.random.key(0), jnp.asarray(Qg), jnp.asarray(h_extra), R, S,
        rule="metropolis", interpret=True,
        debug_randoms=(jnp.asarray(init01), jnp.asarray(u)),
        **{k: jnp.asarray(v) for k, v in betas.items()})
    got = sa_torch.sa_sample_groups_plain(
        T(Qg), T(h_extra), R, S, host_variates=(T(init01), T(u)),
        **{k: T(v) for k, v in betas.items()})
    assert tuple(got.shape) == (G, B, R, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,fold", [(300, 2), (243, 4)])
def test_wide_groups_match_lane_kernel(n, fold):
    """Above n = 241, where the card runs K4 (``anneal_wide.cu``) instead of
    K1: the plain anneal still equals the lane kernel in interpret mode, at
    the lane folds of such widths, exactly."""
    G, B, R, S = 2, 2, 4, 3
    assert lane_geometry(n, B, R, groups=G)[3] == fold
    Qg, h_extra, init01, u = _structured(n, G, B, n, R, S)
    want = lane_sample_groups(jax.random.key(0), jnp.asarray(Qg), jnp.asarray(h_extra), R, S,
                              rule="metropolis", interpret=True,
                              debug_randoms=(jnp.asarray(init01), jnp.asarray(u)))
    got = sa_torch.sa_sample_groups_plain(T(Qg), T(h_extra), R, S,
                                          host_variates=(T(init01), T(u)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fits_shared_is_the_boundary_of_the_anneal_kernels():
    """n ≤ 241 runs K1/K2 (J_g in one block's 232,448 bytes of shared
    memory), wider n K4; on CPU tensors every width runs the plain version
    and launches nothing."""
    assert kernel_call.fits_shared(1) and kernel_call.fits_shared(241)
    assert not kernel_call.fits_shared(242) and not kernel_call.fits_shared(717)
    assert 4 * 241 ** 2 <= kernel_call.SMEM_BYTES < 4 * 242 ** 2
    Q, init01, u = _dense(12, 1, 250, 2, 2)
    sa_cuda.reset_launch_counts()
    wide_cuda.reset_launch_counts()
    got = sa_cuda.sa_sample_batch_cuda(T(Q), 2, 2, host_variates=(T(init01), T(u)))
    assert torch.equal(got, sa_torch.sa_sample_batch_plain(T(Q), 2, 2,
                                                           host_variates=(T(init01), T(u))))
    assert sa_cuda.launch_counts == {"sa_metropolis": 0}
    assert wide_cuda.launch_counts == {"anneal_wide": 0, "anneal_wide_sparse": 0,
                                       "anneal_wide_global": 0, "anneal_wide_global_sparse": 0}


@pytest.mark.parametrize("B,n,R,S", [
    (3, 5, 16, 8),
    (2, 20, 8, 6),
    (2, 6, 8, 1),   # a single sweep runs cold
])
def test_batch_matches_packed_kernel(B, n, R, S):
    Q, init01, u = _dense(n * 1000 + B, B, n, R, S)
    want = sa_sample_batch_pallas(jax.random.key(0), jnp.asarray(Q), R, S, interpret=True,
                                  debug_randoms=(jnp.asarray(init01), jnp.asarray(u)))
    got = sa_torch.sa_sample_batch_plain(T(Q), R, S, host_variates=(T(init01), T(u)))
    assert tuple(got.shape) == (B, R, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,R", [(4, 9), (13, 5)])
def test_sweep_matches_xla_sweep(n, R):
    """One sweep at a fixed beta: ``metropolis_sweep`` on thresholds equals
    ``sa_jax._metropolis_sweep`` on the uniforms they come from."""
    Q, init01, u = _dense(7 * n, 1, n, R, 1)
    h, J = sa_torch.split_qubo(T(Q[0]))
    beta = np.float32(0.7)
    want = _metropolis_sweep(jnp.asarray(init01[0]), jnp.asarray(u[0, 0]), beta,
                             jnp.asarray(h.numpy()), jnp.asarray(J.numpy()))
    thr = -torch.log(T(u[0, 0])) / T(beta)
    got = sa_torch.metropolis_sweep(T(init01[0]).clone(), thr, h, J)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_structured_default_schedule_matches_dense():
    """Per-problem endpoints of the structured form equal default_beta_range
    on the densified batch, in this package (exactly) and in qbmx (rtol 1e-6:
    float32 sums in another order)."""
    G, B, n = 2, 4, 10
    Qg, h_extra, _, _ = _structured(11, G, B, n, 1, 1)
    h_extra[0, 1] = 0.0  # zero magnitudes are ignored
    hs, J = sa_torch.split_qubo(T(Qg))
    hot, logr = sa_torch.schedule_params(hs[:, None] + T(h_extra), J[:, None], 5)
    dense = api.densify_groups(T(Qg), T(h_extra))
    d_hot, d_cold = default_beta_range(dense)
    assert torch.equal(hot.reshape(-1), d_hot)
    assert torch.equal(logr.reshape(-1), torch.log(d_cold / d_hot))
    j_hot, j_cold = j_default_beta_range(jnp.asarray(dense.numpy()))
    np.testing.assert_allclose(hot.reshape(-1).numpy(), np.asarray(j_hot), rtol=1e-6)
    np.testing.assert_allclose(d_cold.numpy(), np.asarray(j_cold), rtol=1e-6)


def test_single_sweep_runs_cold():
    h = T(np.random.default_rng(0).normal(size=(2, 3, 4)).astype(np.float32))
    J = torch.zeros((2, 1, 4, 4))
    hot, logr = sa_torch.schedule_params(h, J, 1, beta_hot=0.1, beta_cold=4.0)
    assert torch.all(hot == 4.0) and torch.all(logr == 0.0)


def test_densify_groups_matches():
    Qg, h_extra, _, _ = _structured(3, 2, 3, 5, 1, 1)
    want = japi.densify_groups(jnp.asarray(Qg), jnp.asarray(h_extra))
    np.testing.assert_array_equal(api.densify_groups(T(Qg), T(h_extra)).numpy(),
                                  np.asarray(want))


def _oracle_problem(n):
    return random_qubo_batch(np.random.default_rng(0), 1, n, scale=0.5)


@pytest.mark.parametrize("n", [2, 5, 8])
def test_generator_path_matches_oracle(n):
    """512 reads, 200 sweeps: marginals within 0.12 of the exact marginals
    at the cold beta (tests/test_samplers.py::test_marginals_match_oracle)."""
    Q = _oracle_problem(n)
    s = sa_torch.sa_sample_batch_plain(Q, 512, 200, generator=torch.Generator().manual_seed(1))
    assert tuple(s.shape) == (1, 512, n)
    assert set(s.unique().tolist()) <= {0.0, 1.0}
    _, cold = default_beta_range(Q[0])
    _, _, marg, _ = exact_boltzmann(Q[0], beta=float(cold))
    assert torch.allclose(s[0].mean(0), marg, atol=0.12)


def test_generator_path_finds_ground_state():
    Q = random_qubo_batch(np.random.default_rng(0), 1, 8, scale=3.0)
    states = enumerate_states(8)
    gs = states[int(torch.argmin(qubo_energies(Q[0], states)))]
    s = sa_torch.sa_sample_batch_plain(Q, 256, 300, generator=torch.Generator().manual_seed(2))
    assert (s[0] == gs).all(dim=1).float().mean() > 0.5


def test_generator_chains_are_decorrelated():
    Q = random_qubo_batch(np.random.default_rng(0), 1, 6, scale=0.2)
    s = sa_torch.sa_sample_groups_plain(Q, torch.zeros((1, 1, 6)), 64, 50,
                                        generator=torch.Generator().manual_seed(3),
                                        beta_hot=0.5, beta_cold=1.0)
    assert len({tuple(r) for r in s[0, 0].tolist()}) > 5


def test_generator_batch_tracks_each_oracle():
    # problems SA anneals well: on some random problems it freezes into a
    # local minimum in ~15-20% of chains in both packages (the second
    # problem of default_rng(0), for one), which no sampler fix changes
    Q = random_qubo_batch(np.random.default_rng(3), 3, 5, scale=1.0)
    out = sa_torch.sa_sample_batch_plain(Q, 256, 100, generator=torch.Generator().manual_seed(4))
    for b in range(3):
        _, cold = default_beta_range(Q[b])
        _, _, marg, _ = exact_boltzmann(Q[b], beta=float(cold))
        assert torch.allclose(out[b].mean(0), marg, atol=0.15)


def test_generator_is_reproducible():
    Q = random_qubo_batch(np.random.default_rng(6), 2, 5)
    a, b = (sa_torch.sa_sample_batch_plain(Q, 16, 10, generator=torch.Generator().manual_seed(9))
            for _ in range(2))
    assert torch.equal(a, b)


@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((2**32 - 1,) * 4, (2**32 - 1,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(counter, key, want):
    """Random123's known-answer vectors for Philox4x32-10."""
    assert tuple(int(w) for w in sa_torch.philox4x32_10(counter, key)) == want


def test_philox_variates_layout():
    """Per-problem streams: a problem's variates depend on (seed, problem
    index) only; uniforms lie in [0, 1) on the 2^-24 grid."""
    init01, u = sa_torch.philox_variates(2**40 + 7, 2, 3, 5, 6, 4)
    assert init01.shape == (2, 3, 5, 6) and u.shape == (4, 2, 3, 6, 5)
    assert set(np.unique(init01)) == {0.0, 1.0}
    assert u.min() >= 0.0 and u.max() < 1.0 and np.all(u * 2**24 == np.round(u * 2**24))
    i2, u2 = sa_torch.philox_variates(2**40 + 7, 1, 4, 5, 6, 4)  # problems 0..3
    np.testing.assert_array_equal(i2[0, :3], init01[0])
    np.testing.assert_array_equal(u2[:, 0, 3], u[:, 1, 0])
    _, u3 = sa_torch.philox_variates(2**40 + 8, 2, 3, 5, 6, 4)
    assert not np.array_equal(u3, u)


def test_wrappers_run_the_plain_version_on_cpu():
    """On CPU tensors the kernel wrappers run the plain version and launch
    nothing."""
    Qg, h_extra, init01, u = _structured(8, 2, 3, 5, 4, 3)
    sa_cuda.reset_launch_counts()
    got = sa_cuda.sa_sample_groups_cuda(T(Qg), T(h_extra), 4, 3, host_variates=(T(init01), T(u)))
    want = sa_torch.sa_sample_groups_plain(T(Qg), T(h_extra), 4, 3,
                                           host_variates=(T(init01), T(u)))
    assert torch.equal(got, want)
    Q, i1, u1 = _dense(9, 2, 5, 4, 3)
    assert torch.equal(sa_cuda.sa_sample_batch_cuda(T(Q), 4, 3, host_variates=(T(i1), T(u1))),
                       sa_torch.sa_sample_batch_plain(T(Q), 4, 3, host_variates=(T(i1), T(u1))))
    assert sa_cuda.launch_counts == {"sa_metropolis": 0}


def test_host_variates_shape_is_checked():
    Q, init01, u = _dense(10, 2, 5, 4, 3)
    with pytest.raises(ValueError, match="host_variates"):
        sa_torch.sa_sample_batch_plain(T(Q), 4, 3, host_variates=(T(init01), T(u[:2])))


def test_require_refuses_what_the_kernel_does_not_take():
    ok = torch.zeros((2, 3))
    kernel_call.require(ok, "x", (2, 3), ok.device)
    for bad in (ok.double(), ok.t(), torch.zeros((3, 2))):
        with pytest.raises(ValueError):
            kernel_call.require(bad, "x", (2, 3), ok.device)


def test_structured_checks_of_the_anneal_kernels():
    """The argument checks K1 and K2 share (they need no GPU)."""
    G, B, n, R, S = 2, 3, 4, 5, 6
    J, h, hot = torch.zeros((G, n, n)), torch.zeros((G, B, n)), torch.zeros((G, B))
    hv = (torch.zeros((G, B, R, n)), torch.zeros((S, G, B, n, R)))
    ptrs = kernel_call.structured_ptrs("k", 256, J, h, hot, hot, R, S, hv)
    assert len(ptrs) == 6 and None not in ptrs
    assert kernel_call.structured_ptrs("k", 256, J, h, hot, hot, R, S, None)[4:] == (None, None)
    with pytest.raises(ValueError, match="uniforms"):
        kernel_call.structured_ptrs("k", 256, J, h, hot, hot, R, S + 1, hv)
    with pytest.raises(ValueError, match="host_variates"):
        kernel_call.structured_ptrs("k", 256, J, h, hot, hot, R, S, hv[:1])
    with pytest.raises(ValueError, match="logr"):
        kernel_call.structured_ptrs("k", 256, J, h, hot, hot[:1], R, S, None)
    with pytest.raises(ValueError, match="exceeds its bound"):
        kernel_call.structured_ptrs("k", 3, J, h, hot, hot, R, S, None)
    kernel_call.check_rc("k", 0)
    with pytest.raises(RuntimeError, match="cudaError 700"):
        kernel_call.check_rc("k", 700)


@pytest.mark.parametrize("name,use_kernel", [("SA", True), ("sa-pallas", True),
                                             ("SA-JAX", False), ("SA-TORCH", False)])
def test_registry_sa_names(name, use_kernel):
    s = api.get_sampler(name, num_sweeps=7)
    assert isinstance(s, api.SASampler) and s.num_sweeps == 7 and s.use_kernel is use_kernel


@pytest.mark.parametrize("name", ["SA-NATIVE", "Advantage_system4.1", "DW_2000Q_6",
                                  "FujitsuDAU"])
def test_registry_refuses_unported_solvers(name):
    """The solvers once refused for want of a port: ``SA-NATIVE`` now
    samples, the D-Wave names reach the QPU adapters' ``from_ocean``, which
    raises ``qbmx``'s guidance without the Ocean SDK, and ``FujitsuDAU``
    raises as in ``qbmx``."""
    if name == "SA-NATIVE":
        from qbmx_torch.samplers.native import NativeSASampler

        assert isinstance(api.get_sampler(name, num_sweeps=7), NativeSASampler)
        return
    with pytest.raises(NotImplementedError, match="Ocean" if name != "FujitsuDAU"
                       else "annealer-free"):
        api.get_sampler(name)


@pytest.mark.parametrize("name,kind", [("BMS", api.GibbsSampler), ("PT", api.PTSampler)])
def test_registry_runs_the_ported_solvers(name, kind):
    """BMS and PT, once refused, now sample: binary (G, B, R, n) from the
    structured entry, reproducible from the generator."""
    s = api.get_sampler(name, num_sweeps=6)
    assert isinstance(s, kind)
    Qg, h_extra, _, _ = _structured(13, 2, 3, 5, 1, 1)
    run = lambda: api.sampler_sample_groups(s, torch.Generator().manual_seed(0), T(Qg),
                                            T(h_extra), 8)
    out = run()
    assert tuple(out.shape) == (2, 3, 8, 5) and set(out.unique().tolist()) <= {0.0, 1.0}
    assert torch.equal(out, run())


def test_registry_unknown_solver():
    with pytest.raises(ValueError):
        api.get_sampler("nope")


def test_samplers_agree_on_cpu():
    """"SA" and "SA-TORCH" take the same path on CPU tensors, so one seed
    gives one result; the densify fallback serves samplers without
    ``sample_groups``."""
    Qg, h_extra, _, _ = _structured(12, 2, 3, 4, 1, 1)
    a = api.sampler_sample_groups(api.get_sampler("SA", 10), torch.Generator().manual_seed(0),
                                  T(Qg), T(h_extra), 8)
    b = api.sampler_sample_groups(api.get_sampler("SA-TORCH", 10),
                                  torch.Generator().manual_seed(0), T(Qg), T(h_extra), 8)
    assert tuple(a.shape) == (2, 3, 8, 4) and torch.equal(a, b)
    e = api.sampler_sample_groups(api.get_sampler("EXACT"), torch.Generator().manual_seed(0),
                                  T(Qg), T(h_extra), 4000)
    dense = api.densify_groups(T(Qg), T(h_extra))
    _, _, marg, _ = exact_boltzmann(dense[4])
    assert tuple(e.shape) == (2, 3, 4000, 4)
    assert torch.allclose(e[1, 1].mean(0), marg, atol=0.04)
