"""The QPU seam (qbmx_torch.samplers.qpu) against qbmx.samplers.qpu.

``qbmx``'s fake samplers (``tests/test_qpu_adapter.py``,
``tests/test_embedding.py``; copied here) drive both packages' adapters,
each package with its own fake built from the same seed, and the samples
must be equal exactly: shuffled variable order, the histogram answer mode,
retry and refresh, ``copies`` (read-major de-interleave and the counters),
the Chimera fast path around a defective block, the heuristic path, the
oversized-problem error and the copies warning.  The one place the
packages differ by decision is a short delivery (``_pad_reads``): the port
keeps the delivered rows and fills the rest by uniform resampling from the
call's generator.  The slice: three matched ``DiscQBM`` and CDQBM (CLI
defaults, n=41) steps through the structured adapter over a deterministic
structured stub equal within 1e-5; the CLI flags reach the registry; the
seed sweeps refuse the adapters as ``qbmx``'s do.
"""

from __future__ import annotations

import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qbmx.embedding as je
import qbmx.samplers.qpu as jq
import qbmx_torch.embedding as te
import qbmx_torch.samplers.qpu as tq
from qbmx_torch.samplers import api
from test_torch_dqbm import _close, _close_tree, _jparams, _params

torch.set_num_threads(1)
CHIMERA_TOPO = {"type": "chimera", "shape": [2, 2, 4]}


# -- qbmx's fakes --------------------------------------------------------------


class FakeSampleSet:
    def __init__(self, samples, variables, qpu_us=123.0):
        self.record = types.SimpleNamespace(sample=np.asarray(samples))
        self.variables = list(variables)
        self.info = {"timing": {"qpu_access_time": qpu_us}}


class FakeDimodSampler:
    """Solves the QUBO exactly by enumeration — a stand-in 'QPU'."""

    def __init__(self, shuffle_vars=False, fail_times=0):
        self.shuffle_vars = shuffle_vars
        self.fail_times = fail_times
        self.calls = 0

    def sample_qubo(self, qdict, num_reads=1, **_):
        self.calls += 1
        if self.fail_times > 0:
            self.fail_times -= 1
            raise ConnectionResetError("flaky network")
        n = max(max(i, j) for i, j in qdict) + 1
        Q = np.zeros((n, n))
        for (i, j), v in qdict.items():
            Q[i, j] += v
        best, best_e = None, np.inf
        for m in range(2**n):
            s = np.array([(m >> k) & 1 for k in range(n)], dtype=float)
            e = s @ np.triu(Q, 1) @ s + np.diag(Q) @ s
            if e < best_e:
                best, best_e = s, e
        samples = np.tile(best, (num_reads, 1))
        variables = list(range(n))
        if self.shuffle_vars:  # permute reporting order like real samplesets can
            perm = np.asarray([1, 0] + list(range(2, n)))
            samples = samples[:, perm]
            variables = [variables[p] for p in perm]
        return FakeSampleSet(samples, variables)


class PatternSampler:
    """Read r, replica c → a block filled with ``(r * k + c) % 2``."""

    def __init__(self, n):
        self.n = n
        self.reads_seen = []

    def sample_qubo(self, qdict, num_reads=1, **_):
        nv = max(max(i, j) for i, j in qdict) + 1
        k = nv // self.n
        self.reads_seen.append(num_reads)
        rows = [sum(([float((r * k + c) % 2)] * self.n for c in range(k)), [])
                for r in range(num_reads)]
        return FakeSampleSet(rows, list(range(nv)), qpu_us=0.0)


class BoltzmannEnumSampler:
    """Exact-Boltzmann sampler by full enumeration (<= ~12 vars)."""

    def __init__(self, seed=0):
        self.rng = np.random.default_rng(seed)

    def sample_qubo(self, qdict, num_reads=1, **_):
        nv = max(max(i, j) for i, j in qdict) + 1
        Q = np.zeros((nv, nv))
        for (i, j), v in qdict.items():
            Q[i, j] += v
        states = np.array([[(m >> b) & 1 for b in range(nv)] for m in range(2**nv)],
                          dtype=float)
        E = np.einsum("si,ij,sj->s", states, np.triu(Q, 1), states) + states @ np.diag(Q)
        p = np.exp(-(E - E.min()))
        p /= p.sum()
        idx = self.rng.choice(len(states), size=num_reads, p=p)
        return FakeSampleSet(states[idx], list(range(nv)), qpu_us=0.0)


class FakeHistogramSampler:
    """Aggregates identical reads into unique rows + ``num_occurrences``."""

    def __init__(self, p=0.5, seed=0):
        self.rng = np.random.default_rng(seed)
        self.p = p
        self.last_raw = None

    def sample_qubo(self, qdict, num_reads=1, **_):
        n = max(max(i, j) for i, j in qdict) + 1
        raw = (self.rng.random((num_reads, n)) < self.p).astype(float)
        self.last_raw = raw
        uniq, counts = np.unique(raw, axis=0, return_counts=True)
        ss = FakeSampleSet(uniq, list(range(n)))
        ss.record.num_occurrences = counts
        return ss


class FakeHardwareSampler:
    """Structured 'annealer': REJECTS problems not mapped onto its graph,
    then samples by host-side Metropolis annealing over the physical QUBO."""

    def __init__(self, adjacency, topology=None, seed=0, sweeps=150):
        self.adjacency = adjacency
        self.nodelist = sorted(adjacency)
        self.edgelist = sorted((min(u, v), max(u, v)) for u in adjacency for v in adjacency[u])
        self._edgeset = set(self.edgelist)
        self.properties = {"topology": topology} if topology else {}
        self.rng = np.random.default_rng(seed)
        self.sweeps = sweeps
        self.calls = 0

    def check(self, qdict):
        for i, j in qdict:
            if i == j:
                if i not in self.adjacency:
                    raise ValueError(f"qubit {i} is not on this chip")
            elif (min(i, j), max(i, j)) not in self._edgeset:
                raise ValueError(f"coupler ({i},{j}) is not on the hardware graph")

    @staticmethod
    def dense(qdict):
        variables = sorted({q for ij in qdict for q in ij})
        idx = {q: c for c, q in enumerate(variables)}
        Q = np.zeros((len(variables),) * 2)
        for (i, j), v in qdict.items():
            Q[idx[min(i, j)], idx[max(i, j)]] += v
        J = np.triu(Q, 1)
        return variables, np.diag(Q).copy(), J + J.T

    def sample_qubo(self, qdict, num_reads=1, **_):
        self.calls += 1
        self.check(qdict)
        variables, h, Jsym = self.dense(qdict)
        nv = len(variables)
        x = (self.rng.random((num_reads, nv)) < 0.5).astype(float)
        for beta in np.geomspace(0.1, 6.0, self.sweeps):
            for q in self.rng.permutation(nv):
                dE = (1.0 - 2.0 * x[:, q]) * (x @ Jsym[:, q] + h[q])
                p = np.exp(-beta * np.clip(dE, 0.0, 50.0))
                flip = self.rng.random(num_reads) < p
                x[:, q] = np.where(flip, 1.0 - x[:, q], x[:, q])
        return FakeSampleSet(x, variables)


class GreedyHardwareSampler(FakeHardwareSampler):
    """Structured and deterministic: read r starts from a fixed bit pattern
    of (qubit, r) and takes every energy-lowering flip, qubits in order,
    for ``sweeps`` sweeps — the samples are a function of the physical
    QUBO alone, for matched training steps."""

    def sample_qubo(self, qdict, num_reads=1, **_):
        self.calls += 1
        self.check(qdict)
        variables, h, Jsym = self.dense(qdict)
        q = np.asarray(variables, dtype=np.int64)
        r = np.arange(num_reads, dtype=np.int64)
        x = (((q[None, :] * 2654435761 + r[:, None] * 40503) >> 11) & 1).astype(float)
        for _ in range(self.sweeps):
            for c in range(len(variables)):
                dE = (1.0 - 2.0 * x[:, c]) * (x @ Jsym[:, c] + h[c])
                x[:, c] = np.where(dE < 0.0, 1.0 - x[:, c], x[:, c])
        return FakeSampleSet(x, variables)


# -- both packages on one input ---------------------------------------------------


def run_both(make_adapter, Q, num_reads, seed=0):
    """``make_adapter(module)`` built in each package, sampled on ``Q``:
    ``(ours, theirs, our_adapter, their_adapter)``."""
    ta, ja = make_adapter(tq), make_adapter(jq)
    ours = ta.sample_batch(torch.Generator().manual_seed(seed), torch.as_tensor(Q), num_reads)
    assert ours.dtype == torch.float32 and ours.device.type == "cpu"
    theirs = np.asarray(ja.sample_batch(jax.random.key(seed), jnp.asarray(Q), num_reads))
    return ours.numpy(), theirs, ta, ja


def counters(a):
    return (a.qpu_time_used, a.reads_requested, a.samples_returned)


def test_qubo_dict_and_ordered_samples_equal():
    A = np.random.default_rng(0).uniform(-1, 1, (4, 4)).astype(np.float32)
    for Q in (A, np.triu(A), np.diag(np.diag(A)), np.zeros((3, 3), np.float32)):
        assert tq._qubo_dict(Q) == jq._qubo_dict(Q)
    ss = FakeSampleSet([[1, 0, 1], [0, 0, 1]], variables=[2, 0, 1])
    np.testing.assert_array_equal(tq._ordered_samples(ss, 3), jq._ordered_samples(ss, 3))
    ss.record.num_occurrences = np.asarray([3, 1])
    np.testing.assert_array_equal(tq._ordered_samples(ss, 3), jq._ordered_samples(ss, 3))


@pytest.mark.parametrize("shuffle", [False, True])
def test_shuffled_variable_order(shuffle):
    Q = np.diag([-1.0, 2.0, -3.0]).astype(np.float32)[None]
    ours, theirs, ta, ja = run_both(lambda m: m.QPUSampler(FakeDimodSampler(shuffle)), Q, 5)
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(ours[0, 0], [1.0, 0.0, 1.0])
    assert counters(ta) == counters(ja)


@pytest.mark.parametrize("copies,p,reads", [(1, 0.5, 64), (4, 0.0, 8), (3, 0.3, 30)])
def test_histogram_answer_mode(copies, p, reads):
    Q = np.diag([0.1, -0.2, 0.3]).astype(np.float32)[None]
    ours, theirs, ta, ja = run_both(
        lambda m: m.QPUSampler(FakeHistogramSampler(p=p, seed=3), copies=copies), Q, reads)
    np.testing.assert_array_equal(ours, theirs)
    assert ours.shape == (1, reads, 3) and counters(ta) == counters(ja)


def test_retry_with_refresh_and_the_second_failure():
    Q = np.diag([-1.0, 1.0]).astype(np.float32)[None]
    fresh = {}

    def make(m):
        fresh[m] = FakeDimodSampler()
        return m.QPUSampler(FakeDimodSampler(fail_times=1), refresh=lambda: fresh[m])

    ours, theirs, ta, ja = run_both(make, Q, 3)
    np.testing.assert_array_equal(ours, theirs)
    assert fresh[tq].calls == fresh[jq].calls == 1 and ta.sampler is fresh[tq]
    for m in (tq, jq):
        adapter = m.QPUSampler(FakeDimodSampler(fail_times=2),
                               refresh=lambda: FakeDimodSampler(fail_times=5))
        key = torch.Generator() if m is tq else jax.random.key(0)
        q = torch.as_tensor(Q[:, :1, :1]) if m is tq else jnp.asarray(Q[:, :1, :1])
        with pytest.raises(ConnectionResetError):
            adapter.sample_batch(key, q, 1)


def test_qpu_time_accumulates_alike():
    Q = np.stack([np.diag([-1.0, 1.0])] * 2).astype(np.float32)
    _, _, ta, ja = run_both(lambda m: m.QPUSampler(FakeDimodSampler()), Q, 2)
    assert ta.qpu_time_used == ja.qpu_time_used == pytest.approx(246.0)


@pytest.mark.parametrize("copies,reads", [(1, 40), (10, 40), (10, 43), (4, 4), (8, 3)])
def test_copies_deinterleave_read_major_and_counters(copies, reads):
    n = 2
    Q = np.zeros((2, n, n), np.float32)
    ours, theirs, ta, ja = run_both(lambda m: m.QPUSampler(PatternSampler(n), copies=copies),
                                    Q, reads)
    np.testing.assert_array_equal(ours, theirs)
    k = min(copies, reads)
    np.testing.assert_array_equal(ours[0, :, 0], np.arange(reads) % 2)  # sample r*k + c
    assert counters(ta) == counters(ja)
    assert ta.reads_requested == 2 * -(-reads // k) and ta.samples_returned == 2 * reads
    assert ta.sampler.reads_seen == ja.sampler.reads_seen


@pytest.mark.parametrize("copies", [1, 5])
def test_copies_pack_block_diagonally(copies):
    seen = {}

    def make(m):
        fake = BoltzmannEnumSampler(seed=2)
        orig = fake.sample_qubo

        def spy(qdict, num_reads=1, **kw):
            seen.setdefault(m, []).append(dict(qdict))
            return orig(qdict, num_reads=num_reads, **kw)

        fake.sample_qubo = spy
        return m.QPUSampler(fake, copies=copies)

    Q = np.asarray([[[-0.8, 0.6], [0.0, 0.4]]], np.float32)
    ours, theirs, ta, ja = run_both(make, Q, 50)
    np.testing.assert_array_equal(ours, theirs)
    assert seen[tq] == seen[jq] and len(seen[tq]) == 1
    assert max(max(i, j) for i, j in seen[tq][0]) == 2 * copies - 1
    assert all(i // 2 == j // 2 for i, j in seen[tq][0])  # no cross-replica coupling
    assert counters(ta) == counters(ja)


def test_invalid_copies_rejected_alike():
    for m in (tq, jq):
        with pytest.raises(ValueError, match="copies"):
            m.QPUSampler(FakeDimodSampler(), copies=0)


# -- the structured adapter -------------------------------------------------------


def _structured(adj, topology=None, sweeps=40, seed=0, **kw):
    return lambda m: m.StructuredQPUSampler(
        FakeHardwareSampler(adj, topology=topology, seed=seed, sweeps=sweeps), **kw)


def test_ground_state_recovery_through_embedding_equal():
    Q = np.array([[-2.0, 3.0], [0.0, -1.0]], np.float32)[None]
    ours, theirs, ta, ja = run_both(_structured(te.chimera_graph(2), CHIMERA_TOPO, 200), Q, 64)
    np.testing.assert_array_equal(ours, theirs)
    assert ta.chain_break_fraction == ja.chain_break_fraction < 0.2
    assert ta.embedding_searches == ja.embedding_searches == 1


def test_chimera_fast_path_skips_a_defective_block():
    dead = te.chimera_index(0, 0, 0, 0, 4, 4, 4)
    adj = {k: set(v) for k, v in te.chimera_graph(4).items() if k != dead}
    for nbrs in adj.values():
        nbrs.discard(dead)
    Q = (np.diag([-1.0, 1.0, -1.0, 1.0, -1.0]) + np.triu(np.full((5, 5), 0.1), 1)) \
        .astype(np.float32)[None]
    ours, theirs, ta, ja = run_both(
        _structured(adj, {"type": "chimera", "shape": [4, 4, 4]}, 60, copies=3), Q, 32)
    np.testing.assert_array_equal(ours, theirs)
    embs = ta._embeddings_for(5, False)
    assert embs == ja._embeddings_for(5, False) and len(embs) == 3
    used = {q for e in embs for chain in e.values() for q in chain}
    assert dead not in used and used <= set(adj)
    assert ta.embedding_searches == ja.embedding_searches == 1
    assert ta.chain_break_fraction == ja.chain_break_fraction


@pytest.mark.parametrize("copies", [1, 2])
def test_heuristic_path_without_a_declared_topology(copies):
    Q = np.array([[-2.0, 3.0], [0.0, -1.0]], np.float32)[None]
    ours, theirs, ta, ja = run_both(_structured(te.chimera_graph(2), None, 30, copies=copies),
                                    Q, 16)
    assert ta._topology is None
    np.testing.assert_array_equal(ours, theirs)
    assert ta._embeddings_for(2, False) == ja._embeddings_for(2, False)
    assert ta.embedding_searches == ja.embedding_searches == 1


def test_diag_only_uses_the_trivial_structure_alike():
    Q = np.diag([-1.0, 2.0, -3.0]).astype(np.float32)[None]
    ours, theirs, ta, ja = run_both(
        lambda m: m.StructuredQPUSampler(FakeHardwareSampler(te.chimera_graph(1), sweeps=60),
                                         topology=("chimera", 1, 1, 4)), Q, 16)
    np.testing.assert_array_equal(ours, theirs)
    assert ta.chain_break_fraction == ja.chain_break_fraction == 0.0


def test_copies_deinterleave_read_major_through_embedding():
    def make(m):
        adapter = m.StructuredQPUSampler(
            FakeHardwareSampler(te.chimera_graph(2), topology=CHIMERA_TOPO), copies=2)
        replica_of = {q: c for c, e in enumerate(adapter._embeddings_for(4, False))
                      for ch in e.values() for q in ch}

        def patterned(qdict, num_reads=1, **_):
            variables = sorted({q for ij in qdict for q in ij})
            return FakeSampleSet([[float((r * 2 + replica_of[q]) % 2) for q in variables]
                                  for r in range(num_reads)], variables)

        adapter.sampler.sample_qubo = patterned
        return adapter

    Q = np.zeros((1, 4, 4), np.float32)
    Q[0, 0, 1] = 0.1
    ours, theirs, ta, ja = run_both(make, Q, 4)
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(ours[0, :, 0], [0.0, 1.0, 0.0, 1.0])


def test_oversized_problem_raises_alike():
    Q = np.triu(np.full((40, 40), 0.1, np.float32))[None]
    for m in (tq, jq):
        adapter = _structured(te.chimera_graph(2), CHIMERA_TOPO)(m)
        key, q = ((torch.Generator(), torch.as_tensor(Q)) if m is tq
                  else (jax.random.key(0), jnp.asarray(Q)))
        with pytest.raises(RuntimeError, match="oversized"):
            adapter.sample_batch(key, q, 2)


def test_copies_warning_when_the_chip_is_small():
    Q = np.triu(np.full((5, 5), 0.3, np.float32))[None]
    with pytest.warns(UserWarning, match="1 of 5"):
        ours, theirs, ta, ja = run_both(
            _structured(te.chimera_graph(2), CHIMERA_TOPO, 20, copies=5), Q, 6)
    np.testing.assert_array_equal(ours, theirs)
    assert ours.shape == (1, 6, 5)


def test_one_search_per_structure_and_the_cache_across_packages(tmp_path):
    rng = np.random.default_rng(0)
    Q3 = np.triu(rng.uniform(-1, 1, (4, 3, 3))).astype(np.float32)
    Q5 = np.triu(rng.uniform(-1, 1, (2, 5, 5))).astype(np.float32)
    ta = _structured(te.chimera_graph(2), CHIMERA_TOPO, 20, cache_dir=tmp_path)(tq)
    for rep in range(3):
        ta.sample_batch(torch.Generator().manual_seed(rep), torch.as_tensor(Q3), 4)
        ta.sample_batch(torch.Generator().manual_seed(rep), torch.as_tensor(Q5), 4)
    assert ta.embedding_searches == 2 and ta.sampler.calls == 3 * (4 + 2)
    # qbmx reads the port's cache, and the port qbmx's: no search either way
    ja = _structured(te.chimera_graph(2), CHIMERA_TOPO, 20, cache_dir=tmp_path)(jq)
    ja.sample_batch(jax.random.key(0), jnp.asarray(Q5), 2)
    assert ja.embedding_searches == 0
    other = tmp_path / "qbmx"
    jw = _structured(te.chimera_graph(2), CHIMERA_TOPO, 20, cache_dir=other)(jq)
    jw.sample_batch(jax.random.key(0), jnp.asarray(Q3), 2)
    tr = _structured(te.chimera_graph(2), CHIMERA_TOPO, 20, cache_dir=other)(tq)
    tr.sample_batch(torch.Generator(), torch.as_tensor(Q3), 2)
    assert jw.embedding_searches == 1 and tr.embedding_searches == 0


def test_structured_adapter_needs_a_structured_sampler():
    for m in (tq, jq):
        with pytest.raises(TypeError, match="structured"):
            m.StructuredQPUSampler(types.SimpleNamespace(sample_qubo=None))
    adapter = tq.StructuredQPUSampler(FakeHardwareSampler(te.chimera_graph(1)),
                                      topology=("chimera", 1, 1, 4))
    assert isinstance(adapter, tq.QPUSampler) and adapter.jit_safe is False


# -- a short delivery: the one decided difference -----------------------------------


class _Short:
    """Delivers ``keep(num_reads)`` distinct rows of the requested reads."""

    def __init__(self, keep):
        self.keep = keep

    def sample_qubo(self, qdict, num_reads=1, **_):
        nv = max(max(i, j) for i, j in qdict) + 1
        r = np.arange(self.keep(num_reads))[:, None]
        return FakeSampleSet(((r >> np.arange(nv)) & 1).astype(np.float32), list(range(nv)))


@pytest.mark.parametrize("copies,reads,keep", [(1, 9, 4), (1, 20, 7), (2, 10, 3), (1, 5, 5)])
def test_short_delivery_keeps_its_rows_and_resamples_the_rest(copies, reads, keep):
    Q = np.zeros((1, 5, 5), np.float32)
    ours, theirs, _, _ = run_both(
        lambda m: m.QPUSampler(_Short(lambda r: min(r, keep)), copies=copies), Q, reads)
    delivered = min(reads, copies * min(-(-reads // copies), keep))
    assert ours.shape == (1, reads, 5)
    # the delivered rows first, as qbmx returns them; every padded row is one
    np.testing.assert_array_equal(ours[0, :delivered], theirs[0, :delivered])
    rows = {tuple(r) for r in ours[0, :delivered]}
    assert all(tuple(r) in rows for r in ours[0])
    if delivered == reads:  # nothing short: qbmx's rows exactly
        np.testing.assert_array_equal(ours, theirs)


def test_short_delivery_padding_follows_the_generator():
    Q = torch.zeros((1, 5, 5))
    adapter = tq.QPUSampler(_Short(lambda r: 4))
    pads = {tuple(map(tuple, adapter.sample_batch(torch.Generator().manual_seed(s), Q, 40)[0, 4:]
                      .numpy())) for s in range(4)}
    again = adapter.sample_batch(torch.Generator().manual_seed(0), Q, 40)
    assert len(pads) > 1  # another generator, another padding
    np.testing.assert_array_equal(again, adapter.sample_batch(torch.Generator().manual_seed(0),
                                                              Q, 40))
    # uniform over the delivered rows, not cycled: 36 draws from 4 rows
    counts = np.bincount(torch.as_tensor(again[0, 4:] @ torch.tensor([1., 2, 4, 8, 16]))
                         .long().numpy(), minlength=4)[:4]
    assert counts.sum() == 36 and counts.min() >= 1


def test_zero_reads_delivered_raises():
    adapter = tq.QPUSampler(_Short(lambda r: 0))
    with pytest.raises(RuntimeError, match="zero reads"):
        adapter.sample_batch(torch.Generator(), torch.zeros((1, 2, 2)), 3)


# -- the slice: matched training steps over a deterministic structured stub ---------


def _greedy_adapter(m, m_size, sweeps=2):
    topo = {"type": "chimera", "shape": [m_size, m_size, 4]}
    return m.StructuredQPUSampler(GreedyHardwareSampler(te.chimera_graph(m_size), topo,
                                                        sweeps=sweeps))


def test_three_dqbm_steps_match_qbmx_through_the_structured_adapter():
    import qbmx.models.dqbm as jd
    import qbmx_torch.models.dqbm as td

    D, H, B, R, N = 10, 3, 4, 6, 5
    kw = dict(dim_input=D, n_hidden_nodes=H, sample_count=R)
    jm = jd.DiscQBM(sampler=_greedy_adapter(jq, 3), **kw)
    tm = td.DiscQBM(sampler=_greedy_adapter(tq, 3), device="cpu", **kw)
    d = _params(8, D, H, 1)
    jm.params, tm.params = _jparams(d), td.params_from_numpy(d)
    for step in range(3):
        rng = np.random.default_rng(10 + step)
        x, y = rng.random((B, D)).astype(np.float32), rng.integers(0, 2, B)
        terr, tnll = tm.train_for_one_iteration(x, y, 0.3)
        jerr, jnll = jm.train_for_one_iteration(x, y, 0.3)
        _close(float(tnll), float(jnll), rtol=0, atol=1e-5)
        _close(float(terr), float(jerr), rtol=0, atol=1e-5)
        _close_tree(tm.params, jm.params, rtol=0, atol=1e-5)
    X = np.random.default_rng(20).random((N, D)).astype(np.float32)
    tpred, tprob = tm.predict_batch(X)
    jpred, jprob = jm.predict_batch(X)
    np.testing.assert_array_equal(tpred, jpred)
    _close(tprob, jprob, rtol=0, atol=1e-5)
    assert tm.sampler.embedding_searches == jm.sampler.embedding_searches == 1
    assert counters(tm.sampler) == counters(jm.sampler)
    assert tm.sampler.chain_break_fraction == jm.sampler.chain_break_fraction


def test_three_cdqbm_steps_at_the_cli_defaults_match_qbmx():
    """CDQBM (b), the CLI defaults: deterministic pooling 4, one sequential
    layer of 4, n = 41, batch 3; a 41-variable clique on Chimera C12."""
    import qbmx.models.cdqbm as jc
    import qbmx_torch.models.cdqbm as tc

    from qbmx_torch.cli import cdqbm_main

    flags = cdqbm_main.build_parser().parse_args([])
    kw = dict(image_shape=(28, 28), kernel_size=flags.kernel_size, stride=flags.stride,
              pooling_size=flags.pooling_size, pooling_type=flags.pooling_type,
              sequential_layer_sizes=list(flags.seq_sizes), sample_count=4, seed=44)
    jm = jc.CDQBM(sampler=_greedy_adapter(jq, 12, sweeps=1), **kw)
    tm = tc.CDQBM(sampler=_greedy_adapter(tq, 12, sweeps=1), device="cpu", **kw)
    assert tm.geo.n_total == 41
    tm.params = tc.params_from_numpy(jm.params)
    B = flags.batch_size
    for step in range(3):
        rng = np.random.default_rng(30 + step)
        x = (rng.random((B, 28, 28)) < 0.3).astype(np.float32)
        y = rng.integers(0, 2, B)
        terr, tnll = tm.train_for_one_iteration(x, y, flags.learning_rate)
        jerr, jnll = jm.train_for_one_iteration(x, y, flags.learning_rate)
        _close(float(tnll), float(jnll), rtol=0, atol=1e-5)
        _close(float(terr), float(jerr), rtol=0, atol=1e-5)
        theirs = {k: v for k, v in vars(jm.params).items() if v is not None}
        ours = {k: v for k, v in tc.params_to_numpy(tm.params).items() if v is not None}
        assert ours.keys() == theirs.keys()
        for k, v in ours.items():
            _close(v, theirs[k], rtol=0, atol=1e-5)
    assert tm.sampler.embedding_searches == jm.sampler.embedding_searches == 1
    assert counters(tm.sampler) == counters(jm.sampler)


# -- the registry, the CLIs and the sweeps ------------------------------------------


@pytest.mark.parametrize("name,kw", [("DW_2000Q_6", {}), ("Advantage_system4.1", {}),
                                     ("Advantage_system6.4", {"embedding": "composite"})])
def test_registry_without_ocean_raises_qbmx_s_guidance(name, kw):
    from qbmx.samplers.api import get_sampler as j_get_sampler

    msgs = []
    for get in (api.get_sampler, j_get_sampler):
        with pytest.raises(NotImplementedError, match=r"needs the Ocean SDK \(dwave-system\)") \
                as info:
            get(name, **kw)
        msgs.append(str(info.value).replace("qbmx_torch", "qbmx"))
    assert msgs[0] == msgs[1]


def test_fujitsu_is_refused_alike():
    from qbmx.samplers.api import get_sampler as j_get_sampler

    for get in (api.get_sampler, j_get_sampler):
        with pytest.raises(NotImplementedError, match="annealer-free"):
            get("FujitsuDAU")
    with pytest.raises(ValueError, match="SA-NATIVE"):
        api.get_sampler("nope")


@pytest.fixture
def fake_ocean(monkeypatch):
    """A ``dwave.system`` stand-in: a structured ``DWaveSampler`` on Chimera
    C4 and an ``EmbeddingComposite`` that embeds nothing."""
    made = []

    class DWaveSampler(FakeHardwareSampler):
        """Chimera C4; random bits for any problem on its graph."""

        def __init__(self, **kw):
            super().__init__(te.chimera_graph(4), topology={"type": "chimera",
                                                            "shape": [4, 4, 4]})
            self.kw = kw
            made.append(self)

        def sample_qubo(self, qdict, num_reads=1, **_):
            self.check(qdict)
            variables = sorted({q for ij in qdict for q in ij})
            return FakeSampleSet(self.rng.random((num_reads, len(variables))) < 0.5, variables)

    class EmbeddingComposite(FakeDimodSampler):
        def __init__(self, child):
            super().__init__()
            self.child = child

    module = types.ModuleType("dwave.system")
    module.DWaveSampler, module.EmbeddingComposite = DWaveSampler, EmbeddingComposite
    monkeypatch.setitem(sys.modules, "dwave", types.ModuleType("dwave"))
    monkeypatch.setitem(sys.modules, "dwave.system", module)
    return made


def test_registry_builds_the_adapters_through_ocean(fake_ocean, tmp_path):
    a = api.get_sampler("DW_2000Q_6", copies=3, cache_dir=str(tmp_path), token="t",
                        chain_strength=2.5)
    assert type(a) is tq.StructuredQPUSampler and a.copies == 3 and a.chain_strength == 2.5
    assert fake_ocean[0].kw == {"solver": "DW_2000Q_6", "token": "t"}
    assert a._cache.cache_dir == tmp_path and a._topology == ("chimera", 4, 4, 4)
    assert a.refresh() is fake_ocean[1]
    c = api.get_sampler("Advantage_system4.1", embedding="composite", copies=2)
    assert type(c) is tq.QPUSampler and c.copies == 2
    assert c.sampler.child.kw == {"solver": "Advantage_system4.1"}
    out = c.sample_batch(torch.Generator(), torch.as_tensor(np.diag([-1.0, 1.0])[None]).float(), 3)
    np.testing.assert_array_equal(out[0], [[1.0, 0.0]] * 3)


def test_qbm_main_without_ocean_raises_qbmx_s_guidance():
    from qbmx.cli import qbm_main as jmain
    from qbmx_torch.cli import qbm_main as tmain

    kw = dict(data_set="synthetic", n_hidden_nodes=2, sample_count=4, anneal=2,
              batch_size=100, epochs=1, save="", solver="DW_2000Q")
    for main, extra in ((tmain.main, {"device": "cpu"}), (jmain.main, {})):
        with pytest.raises(NotImplementedError, match=r"needs the Ocean SDK \(dwave-system\)"):
            main(**kw, **extra)


def test_parsers_accept_the_qpu_flags(tmp_path):
    from qbmx_torch.cli import cdqbm_main, qbm_main
    from qbmx_torch.cli._common import qpu_sampler_kwargs

    for mod in (qbm_main, cdqbm_main):
        flags = mod.build_parser().parse_args(
            ["--qpu_copies", "4", "--qpu_embedding", "composite",
             "--embedding_cache", str(tmp_path)])
        assert (flags.qpu_copies, flags.qpu_embedding, flags.embedding_cache) == \
            (4, "composite", str(tmp_path))
        defaults = mod.build_parser().parse_args([])
        assert (defaults.qpu_copies, defaults.qpu_embedding) == (1, "first_party")
    assert qpu_sampler_kwargs() is None
    assert qpu_sampler_kwargs(3, "composite", "d") == {"copies": 3, "embedding": "composite",
                                                       "cache_dir": "d"}


@pytest.mark.parametrize("which", ["dqbm", "cdqbm"])
def test_models_thread_sampler_kwargs_to_the_registry(which, monkeypatch):
    import qbmx_torch.models.cdqbm as cdqbm_mod
    import qbmx_torch.models.dqbm as dqbm_mod

    seen = {}

    def recorder(solver, num_sweeps=1000, **kw):
        seen.update(solver=solver, num_sweeps=num_sweeps, **kw)
        return tq.QPUSampler(FakeDimodSampler(), copies=kw.get("copies", 1))

    if which == "dqbm":
        monkeypatch.setattr(dqbm_mod, "get_sampler", recorder)
        m = dqbm_mod.DiscQBM(dim_input=4, n_hidden_nodes=2, anneal_steps=7, solver="SA",
                             sampler_kwargs={"copies": 3}, device="cpu")
        assert seen == {"solver": "SA", "num_sweeps": 7, "copies": 3}
    else:
        monkeypatch.setattr(cdqbm_mod, "get_sampler", recorder)
        m = cdqbm_mod.CDQBM(image_shape=(6, 6), kernel_size=3, stride=3, anneal=9,
                            sampler_kwargs={"copies": 2}, device="cpu")
        assert seen == {"solver": "SA", "num_sweeps": 9, "copies": 2}
    assert m.sampler.copies == seen["copies"]


@pytest.mark.parametrize("cli", ["qbm_main", "cdqbm_main"])
def test_qpu_flags_reach_the_adapter_and_train(cli, fake_ocean, tmp_path):
    """``--solver DW_...`` with ``--qpu_copies`` and ``--embedding_cache``:
    the structured adapter is built with them and trains on the CPU."""
    import importlib

    main = importlib.import_module(f"qbmx_torch.cli.{cli}").main
    made = []
    orig = tq.StructuredQPUSampler.__init__

    def spy(self, *a, **k):
        orig(self, *a, **k)
        made.append(self)

    kw = (dict(n_hidden_nodes=2, batch_size=300, restricted=False) if cli == "qbm_main"
          else dict(kernel_size=22, pooling_size=4, pooling_type="deterministic",
                    batch_size=300, sequential_layer_sizes=(2,)))
    try:
        tq.StructuredQPUSampler.__init__ = spy
        acc, *_ = main(data_set="synthetic", sample_count=4, anneal=2, epochs=1, save="",
                       solver="DW_2000Q_6", qpu_copies=2, embedding_cache=str(tmp_path),
                       device="cpu", **kw)
    finally:
        tq.StructuredQPUSampler.__init__ = orig
    (adapter,) = made
    assert 0.0 <= acc <= 1.0
    assert adapter.copies == 2 and adapter._cache.cache_dir == tmp_path
    assert adapter.embedding_searches == 1 and list(tmp_path.glob("embeddings_clique_*_x2_*.pkl"))


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_seed_sweeps_refuse_the_qpu_adapters(pkg):
    """``qbmx``'s guard and message, in its order: the DQBM sweep checks
    after building its sampler, the CDQBM sweep before anything."""
    if pkg == "torch":
        import qbmx_torch.models.cdqbm as cm
        from qbmx_torch.train.sweep import SeedParallelCDQBM, SeedParallelDQBM

        adapter, dev = tq.QPUSampler(FakeDimodSampler()), dict(device="cpu")
    else:
        import qbmx.models.cdqbm as cm
        from qbmx.train.sweep import SeedParallelCDQBM, SeedParallelDQBM

        adapter, dev = jq.QPUSampler(FakeDimodSampler()), {}
    with pytest.raises(ValueError, match="seed-parallel sweeps need a jit-safe sampler"):
        SeedParallelDQBM([0, 1], dim_input=4, n_hidden_nodes=2, sampler=adapter, **dev)
    donor = cm.CDQBM(image_shape=(6, 6), kernel_size=3, stride=3, sampler=adapter, **dev)
    with pytest.raises(ValueError, match="seed-parallel sweeps need a jit-safe sampler"):
        SeedParallelCDQBM([0, 1], donor)


def test_seed_sweep_cli_refuses_a_qpu_solver_as_qbmx_does(fake_ocean, monkeypatch):
    """Without Ocean both CLIs stop at the registry; with it, at the
    sweep's guard."""
    from qbmx.cli import qbm_main as jmain
    from qbmx_torch.cli import qbm_main as tmain

    kw = dict(data_set="synthetic", n_hidden_nodes=2, sample_count=4, anneal=2,
              batch_size=100, epochs=1, save="", solver="DW_2000Q_6", seed_sweep=[1, 2])
    for main, extra in ((tmain.main, {"device": "cpu"}), (jmain.main, {})):
        with pytest.raises(ValueError, match="jit-safe"):
            main(**kw, **extra)
    assert len(fake_ocean) == 2  # each package built its adapter
    monkeypatch.undo()  # no Ocean SDK again
    for main, extra in ((tmain.main, {"device": "cpu"}), (jmain.main, {})):
        with pytest.raises(NotImplementedError, match="Ocean"):
            main(**kw, **extra)


def test_port_modules_import_no_jax_sklearn_qbmx_or_matplotlib():
    """In a fresh interpreter: the host seams, the figure modules and the
    user scripts' CLIs (the exact studies, the breastmnist search and
    curves, the data synthesizer) import none of jax, optax, sklearn, qbmx,
    scripts or matplotlib; drawing loads matplotlib."""
    import subprocess
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    code = (
        "import sys\n"
        "from qbmx_torch import embedding\n"
        "from qbmx_torch.samplers import api, native, qpu\n"
        "from qbmx_torch.utils import metrics, plots, viz\n"
        "from qbmx_torch.cli import cdqbm_main, qbm_main\n"
        "from qbmx_torch.cli import (exact_harness, cdqbm_exact_study, cdqbm_breast_exact_study,"
        " cdqbm_multikernel_study, bms_hyper_search, bms_winner_curves,"
        " synthesize_missing_data)\n"
        "bad = sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'optax', 'sklearn', "
        "'qbmx', 'scripts', 'matplotlib'})\n"
        "print('LOADED', bad)\n"
        "plots.get_confusion_matrix([0, 1], [1, 1])\n"
        "print('DRAWN', 'matplotlib' in sys.modules, 'sklearn' in sys.modules)\n"
    )
    import os

    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=root, env={**os.environ, "PYTHONPATH": str(root)}, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "LOADED []" in res.stdout and "DRAWN True False" in res.stdout
