"""K4's shared layout on sparse couplings, on the CPU: the rule that gives
a call the sparse path (``wide_cuda.shared_path``: J_g's row lists in
shared memory, ``csrc/anneal_wide_sparse.cu``) or the dense path (J_g in
tiles, ``csrc/anneal_wide.cu``), the sparse path's shared-memory
reckoning and unit table, and the plain versions the card holds both
paths against, on CDQBM (a)'s own sparse QUBOs, against qbmx.

The QUBOs are the main paths': CDQBM (a)'s step QUBOs (probabilistic
pooling 4, ``--seq_sizes 4``: n = 717, J_g 1.96% nonzeros) and the
restricted flat model's at ``qbm_main -hn 300 -r True`` (n = 301, J_g all
zeros but the output's row and column), each from the seed's initial
parameters, which are qbmx's (``core/threefry``).  Under the same host
variates the plain SA and BMS pair sweeps on CDQBM (a)'s QUBOs equal
qbmx's XLA sweeps (``sa_jax._metropolis_sweep``,
``gibbs._pair_heat_bath_sweep``) on every chain: the two packages sum a
field in different orders, so the bar would admit a near-tie split, but
none occurs on these draws.  ``tests/test_torch_cuda.py`` holds the two
paths against each other bit for bit and against plain on the card.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from test_torch_wide import _betas, _xla_anneal

from qbmx.samplers.gibbs import _pair_heat_bath_sweep
from qbmx.samplers.sa_jax import _metropolis_sweep
from qbmx_torch.cli.compare_kernels import flat_step_qubos
from qbmx_torch.core.qubo import random_qubo_batch, split_qubo
from qbmx_torch.models.cdqbm import cdqbm_a_qubos
from qbmx_torch.samplers import api, gibbs, kernel_call, pt_wide_cuda, sa_torch, wide_cuda

torch.set_num_threads(1)
T = torch.as_tensor


def _nnz(Q):
    return pt_wide_cuda.group_nnz(pt_wide_cuda.row_nnz(split_qubo(Q)[1]))


@pytest.fixture(scope="module")
def cdqbm_a():
    return cdqbm_a_qubos(4, "cpu")


@pytest.mark.parametrize("G,B,R", [(2, 20, 100), (20, 20, 100), (10, 32, 100)])
def test_rule_takes_the_sparse_path_at_cdqbm_a(cdqbm_a, G, B, R):
    """CDQBM (a)'s step call (G=2), its 10-seed sweep's (G=20) and its
    validation chunks (G=10 B=32): the shared layout's sparse path, its
    row lists beside the rule's chains within a block."""
    n = 717
    nnz = _nnz(cdqbm_a[0])
    assert max(nnz) == 10_100 and max(nnz) / n**2 < wide_cuda.SHARED_SPARSE_DENSITY
    geo = wide_cuda.wide_geometry(G, B, R, n)
    assert geo.layout == wide_cuda.SHARED
    assert wide_cuda.shared_path(nnz, n, geo.chains_per_block) == wide_cuda.SPARSE
    smem = wide_cuda.sparse_smem_bytes(n, geo.chains_per_block, pt_wide_cuda.padded(max(nnz)))
    assert smem <= kernel_call.SMEM_BYTES


@pytest.mark.parametrize("restricted,path", [(True, wide_cuda.SPARSE), (False, wide_cuda.DENSE)])
def test_rule_at_the_h300_step(restricted, path):
    """``qbm_main -hn 300`` at its defaults (sc100, bs73: G=2 B=73 R=100,
    n=301): restricted (600 nonzeros in the unclamped group, none in the
    clamped one) on the sparse path; ``-r False`` (a dense ``w_hh``) on
    the dense one."""
    Q, h = flat_step_qubos(300, 73, "cpu", restricted=restricted)
    n = Q.shape[-1]
    assert (n, h.shape) == (301, (2, 73, 301))
    nnz = _nnz(Q)
    if restricted:
        assert nnz == (0, 600)
    geo = wide_cuda.wide_geometry(2, 73, 100, n)
    assert geo.layout == wide_cuda.SHARED
    assert wide_cuda.shared_path(nnz, n, geo.chains_per_block) == path


@pytest.mark.parametrize("restricted", [True, False])
def test_flat_models_tell_their_samplers_a_dense_w_hh(restricted):
    """Unrestricted (``-r False``), the flat model and its seed sweep tell
    their SA and BMS samplers that J_g is dense -- the rule's own answer on
    those QUBOs (``test_rule_at_the_h300_step``) -- so K4 takes its dense
    path without counting J's nonzeros; restricted, the rule decides.  PT
    takes no such hint."""
    from qbmx_torch.models.dqbm import DiscQBM
    from qbmx_torch.train.sweep import SeedParallelDQBM

    for solver in ("SA", "BMS"):
        m = DiscQBM(dim_input=4, n_hidden_nodes=2, solver=solver, restricted=restricted,
                    device="cpu")
        sw = SeedParallelDQBM([0, 1], dim_input=4, n_hidden_nodes=2, solver=solver,
                              restricted=restricted, device="cpu")
        assert m.sampler.dense_couplings is (not restricted)
        assert sw.sampler.dense_couplings is (not restricted)
    assert api.with_dense_couplings(api.get_sampler("PT"), True) == api.get_sampler("PT")


@pytest.mark.parametrize("n", [242, 301, 717, 1056])
def test_rule_takes_the_dense_path_on_random_dense_qubos(n):
    Q = random_qubo_batch(np.random.default_rng(n), 2, n)
    geo = wide_cuda.wide_geometry(2, 20, 100, n)
    assert wide_cuda.shared_path(_nnz(Q), n, geo.chains_per_block) == wide_cuda.DENSE


def test_rule_refuses_no_shared_width():
    """Every width the shared layout takes (242 ≤ n ≤ 1056 at 4,000 and
    40,000 chains) gets a path for J_g empty, at the tie, and dense: the
    sparse path where the lists fit beside the chains, else the dense
    one."""
    for n in range(242, wide_cuda.switch_n() + 1):
        for G in (2, 20):
            C = wide_cuda.wide_geometry(G, 20, 100, n).chains_per_block
            tie = int(wide_cuda.SHARED_SPARSE_DENSITY * n * n)
            assert wide_cuda.shared_path((0,), n, C) == wide_cuda.SPARSE
            fits = wide_cuda.sparse_smem_bytes(n, C, pt_wide_cuda.padded(tie)) \
                <= kernel_call.SMEM_BYTES
            assert wide_cuda.shared_path((0, tie), n, C) == (
                wide_cuda.SPARSE if fits else wide_cuda.DENSE)
            assert wide_cuda.shared_path((tie + 1, 0), n, C) == wide_cuda.DENSE
            assert wide_cuda.shared_path((n * (n - 1),), n, C) == wide_cuda.DENSE


@pytest.mark.parametrize("n,chains,nnz_pad", [(242, 1, 8), (301, 32, 608), (717, 31, 10_104),
                                              (717, 32, 10_104), (1056, 31, 2_112)])
def test_sparse_smem_reckoning(n, chains, nnz_pad):
    """The sparse path's block: row lists (4 + 2 bytes an entry, n + 1
    offsets rounded up to 4), the unit table (3n floats rounded up to 4),
    and the dense path's chain rows (n rounded up to 8 floats and as many
    bytes) -- K5's sparse block without its energies, plus the table."""
    frow = -(-n // 8) * 8
    offsets = -(-(n + 1) // 4) * 4
    units = -(-(3 * n) // 4) * 4
    want = 6 * nnz_pad + 4 * offsets + 4 * units + chains * (4 * frow + frow)
    assert wide_cuda.sparse_smem_bytes(n, chains, nnz_pad) == want
    assert wide_cuda.units_len(n) == units
    assert want == pt_wide_cuda.sparse_smem_bytes(n, chains, nnz_pad) - 8 * chains + 4 * units
    assert (want - chains * 5 * frow) % 16 == 0  # the chains' fields start 16-byte aligned


@pytest.mark.parametrize("n", [1, 2, 3, 5, 13, 717])
def test_unit_couplings_are_js_entries(n):
    """The sparse path's unit table: J_g[i, i+k] at 3i + k − 1 (k = 1, 2,
    3), zero past n and in the padding -- the couplings a pair or quad
    decision reads, J's own entries."""
    rng = np.random.default_rng(n)
    Q = random_qubo_batch(rng, 2, n)
    if n == 717:
        Q = cdqbm_a_qubos(1, "cpu")[0]
    J = split_qubo(Q)[1]
    table = wide_cuda.unit_couplings(J)
    assert table.shape == (2, wide_cuda.units_len(n)) and table.dtype == torch.float32
    for i in range(n):
        for k in (1, 2, 3):
            want = J[:, i, i + k] if i + k < n else torch.zeros(2)
            assert torch.equal(table[:, 3 * i + k - 1], want)
    assert not table[:, 3 * n:].any()


def test_the_sparse_rule_is_one_constant():
    """The tie is ``SHARED_SPARSE_DENSITY`` of n² nonzeros in the densest
    group, at n = 301 (where the lists fit far past it)."""
    n, C = 301, 32
    tie = int(wide_cuda.SHARED_SPARSE_DENSITY * n * n)
    assert wide_cuda.shared_path((tie, 0), n, C) == wide_cuda.SPARSE
    assert wide_cuda.shared_path((tie + 1, 0), n, C) == wide_cuda.DENSE
    assert wide_cuda.shared_path((tie // 2, tie + 1), n, C) == wide_cuda.DENSE


def _cdqbm_dense_batch(cdqbm_a, B):
    """CDQBM (a)'s first B problems of each group as a dense batch (2B, n, n)."""
    Q2, h2 = cdqbm_a
    return api.densify_groups(Q2, h2[:, :B]).contiguous()


def _host_variates(B, R, S, n, seed):
    rng = np.random.default_rng(seed)
    init01 = (rng.random((B, R, n)) < 0.5).astype(np.float32)
    u = np.clip(rng.random((S, B, n, R)), 1e-6, 1 - 1e-6).astype(np.float32)
    return init01, u


def test_plain_sa_matches_qbmx_xla_on_cdqbm_a(cdqbm_a):
    """The plain SA the card's sparse path is held against, on CDQBM (a)'s
    QUBOs (4 problems, R = 3, S = 3 past sweep 0), equals qbmx's XLA
    Metropolis sweeps on every chain."""
    Q = _cdqbm_dense_batch(cdqbm_a, 2)
    R, S = 3, 3
    init01, u = _host_variates(Q.shape[0], R, S, Q.shape[-1], 717)
    got = sa_torch.sa_sample_batch_plain(Q, R, S, host_variates=(T(init01), T(u)))
    want = _xla_anneal(Q.numpy(), init01, u, _betas(Q.numpy(), S, "metropolis"),
                       _metropolis_sweep)
    np.testing.assert_array_equal(got.numpy(), want)


def test_plain_bms_pair_matches_qbmx_xla_on_cdqbm_a(cdqbm_a):
    """... and the plain BMS pair sweep, qbmx's XLA pair heat-bath sweeps."""
    Q = _cdqbm_dense_batch(cdqbm_a, 2)
    R, S = 3, 3
    init01, u = _host_variates(Q.shape[0], R, S, Q.shape[-1], 718)
    got = gibbs.gibbs_sample_batch_plain(Q, R, S, beta=1.0, pair=True,
                                         host_variates=(T(init01), T(u)))
    want = _xla_anneal(Q.numpy(), init01, u, _betas(Q.numpy(), S, "heatbath"),
                       _pair_heat_bath_sweep)
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the wrappers run the plain version at CDQBM (a)'s
    width and launch nothing: the tensor's device alone decides."""
    from qbmx_torch.samplers import gibbs_cuda, sa_cuda

    Q2, h2 = cdqbm_a_qubos(1, "cpu")
    init01, u = _host_variates(2, 2, 1, 717, 5)
    hv = (T(init01).reshape(2, 1, 2, 717), T(u).reshape(1, 2, 1, 717, 2))
    wide_cuda.reset_launch_counts()
    got = sa_cuda.sa_sample_groups_cuda(Q2, h2, 2, 1, host_variates=hv)
    assert torch.equal(got, sa_torch.sa_sample_groups_plain(Q2, h2, 2, 1, host_variates=hv))
    got = gibbs_cuda.gibbs_sample_groups_cuda(Q2, h2, 2, 1, pair=True, host_variates=hv)
    assert torch.equal(got, gibbs.gibbs_sample_groups_plain(Q2, h2, 2, 1, pair=True,
                                                            host_variates=hv))
    assert sum(wide_cuda.launch_counts.values()) == 0
