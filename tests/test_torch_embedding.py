"""qbmx_torch.embedding against qbmx.embedding: every public function on
the cases of ``tests/test_embedding.py`` gives equal results (the same
embeddings for the same ``seed``, the same physical QUBO dicts, the same
reports and errors), and an ``EmbeddingCache`` directory written by either
package is read by the other."""

from __future__ import annotations

import pickle

import numpy as np
import pytest

import qbmx.embedding as je
import qbmx_torch.embedding as te

CLIQUE = lambda n: [(u, v) for u in range(n) for v in range(u + 1, n)]  # noqa: E731


def both(name, *args, **kwargs):
    """``name`` called in each package on the same arguments."""
    return getattr(te, name)(*args, **kwargs), getattr(je, name)(*args, **kwargs)


def _without(adj, q):
    adj = {k: set(v) for k, v in adj.items() if k != q}
    for nbrs in adj.values():
        nbrs.discard(q)
    return adj


@pytest.mark.parametrize("m,n,t", [(1, None, 4), (2, None, 4), (3, 2, 4), (4, None, 2)])
def test_chimera_graph_and_index(m, n, t):
    ours, theirs = both("chimera_graph", m, n, t)
    assert ours == theirs
    cols = m if n is None else n
    for r, c, s, k in [(0, 0, 0, 0), (m - 1, cols - 1, 1, t - 1), (0, cols - 1, 1, 0)]:
        assert te.chimera_index(r, c, s, k, m, cols, t) == je.chimera_index(r, c, s, k, m, cols, t)


def test_adjacency_from_edgelist_and_fingerprint():
    edges, nodes = [(0, 1), (1, 2), (3, 3), (2, 0)], [5]
    ours, theirs = both("adjacency_from_edgelist", edges, nodes)
    assert ours == theirs
    for g in (te.chimera_graph(1), te.chimera_graph(2), ours):
        assert te.target_fingerprint(g) == je.target_fingerprint(g)
    assert te.target_fingerprint(te.chimera_graph(1)) != te.target_fingerprint(te.chimera_graph(2))


@pytest.mark.parametrize("n_vars,m,offset", [(2, 2, (0, 0)), (3, 2, (0, 0)), (5, 2, (0, 0)),
                                             (8, 2, (0, 0)), (9, 2, (0, 0)), (4, 4, (2, 3)),
                                             (4, 4, (3, 3)), (0, 2, (0, 0))])
def test_clique_embedding_chimera(n_vars, m, offset):
    ours, theirs = both("clique_embedding_chimera", n_vars, m, cell_offset=offset)
    assert ours == theirs


@pytest.mark.parametrize("case", ["valid", "disconnected", "reused", "no_coupler", "off_chip",
                                  "missing_var", "allowed_missing"])
def test_verify_embedding(case):
    adj = te.chimera_graph(1)
    q = lambda s, k: te.chimera_index(0, 0, s, k, 1, 1, 4)  # noqa: E731
    emb, edges, allow = {
        "valid": (te.clique_embedding_chimera(3, 1), CLIQUE(3), ()),
        "disconnected": ({0: (q(0, 0), q(0, 1))}, [], ()),
        "reused": ({0: (q(0, 0),), 1: (q(0, 0),)}, [], ()),
        "no_coupler": ({0: (q(0, 0),), 1: (q(0, 1),)}, [(0, 1)], ()),
        "off_chip": ({0: (999,)}, [], ()),
        "missing_var": ({0: (q(0, 0),)}, [(0, 1)], ()),
        "allowed_missing": ({0: (q(0, 0),)}, [(0, 1)], (1,)),
    }[case]
    ours, theirs = both("verify_embedding", emb, edges, adj, allow_missing_vars=allow)
    assert ours == theirs
    assert (ours == []) == (case in ("valid", "allowed_missing"))


@pytest.mark.parametrize("edges,m,kw", [
    ([(i, (i + 1) % 8) for i in range(8)], 1, dict(seed=0, tries=8, rounds=24)),
    (CLIQUE(4), 1, dict(seed=0)),
    (CLIQUE(4), 2, dict(seed=3, tries=2, rounds=4)),
])
def test_find_embedding(edges, m, kw):
    ours, theirs = both("find_embedding", edges, te.chimera_graph(m), **kw)
    assert ours == theirs


@pytest.mark.parametrize("n,m,seed,ladder", [(4, 1, 0, je.EFFORT_LADDER),
                                             (5, 2, 1, je.EFFORT_LADDER),
                                             (2, 1, 7, je.EFFORT_LADDER),
                                             (4, 0, 0, ((2, 4),))])
def test_escalating_find_embedding(n, m, seed, ladder):
    adj = te.chimera_graph(m) if m else te.adjacency_from_edgelist([(0, 1), (1, 2)])
    ours, theirs = both("escalating_find_embedding", CLIQUE(n), adj, variables=range(n),
                        seed=seed, ladder=ladder)
    assert ours == theirs
    assert (ours is None) == (m == 0)
    assert te.EFFORT_LADDER == je.EFFORT_LADDER


@pytest.mark.parametrize("adj_of,k,seed,buffer", [
    (lambda: te.chimera_graph(4), 4, 0, False),
    (lambda: te.chimera_graph(3), 2, 0, True),
    (lambda: te.chimera_graph(2), 3, 5, False),
    (lambda: {**{u: {v for v in range(4) if v != u} for u in range(4)},
              **{u: {v for v in range(10, 14) if v != u} for u in range(10, 14)}}, 2, 0, False),
    (lambda: _without(te.chimera_graph(4), 0), 10, 2, False),
])
def test_partition_target_and_subgraph(adj_of, k, seed, buffer):
    adj = adj_of()
    ours, theirs = both("partition_target", adj, k, seed=seed, buffer=buffer)
    assert ours == theirs
    for region in ours:
        assert te.subgraph(adj, region) == je.subgraph(adj, region)


def test_partition_target_refuses_the_same_counts():
    for k in (0, 9):
        for mod in (te, je):
            with pytest.raises(ValueError, match="cannot partition"):
                mod.partition_target(te.chimera_graph(1), k)


@pytest.mark.parametrize("qdict", [{(0, 1): 0.1, (0, 0): 1.0}, {(0, 1): 40.0, (0, 0): 1.0},
                                   {(0, 0): -3.0}, {}, {(0, 1): -0.5, (1, 2): 0.25, (2, 2): 1.0}])
def test_chain_strength_for(qdict):
    ours, theirs = both("chain_strength_for", qdict)
    assert ours == theirs


@pytest.mark.parametrize("n,m,cs", [(3, 1, 2.0), (2, 1, None), (5, 2, None), (4, 2, 0.7)])
def test_embed_qubo(n, m, cs):
    adj = te.chimera_graph(m)
    emb = te.clique_embedding_chimera(n, m)
    Q = np.triu(np.random.default_rng(n).uniform(-1, 1, (n, n))).astype(np.float32)
    qdict = {(i, j): float(Q[i, j]) for i in range(n) for j in range(i, n)}
    ours, theirs = both("embed_qubo", qdict, emb, adj, cs)
    assert ours == theirs


@pytest.mark.parametrize("case", ["no_coupler", "disconnected_chain"])
def test_embed_qubo_refuses_alike(case):
    if case == "no_coupler":
        adj = te.chimera_graph(1)
        emb = {0: (te.chimera_index(0, 0, 0, 0, 1, 1, 4),),
               1: (te.chimera_index(0, 0, 0, 1, 1, 1, 4),)}
        qdict, match = {(0, 1): 1.0}, "no physical coupler"
    else:
        adj, emb, qdict, match = {0: {1}, 1: {0, 2}, 2: {1}}, {0: (0, 2)}, {(0, 0): 1.0}, \
            "disconnected"
    msgs = []
    for mod in (te, je):
        with pytest.raises(ValueError, match=match) as info:
            mod.embed_qubo(qdict, emb, adj)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("phys,cols,emb,n_vars", [
    (np.array([[1, 1, 0, 1], [0, 0, 0, 0], [1, 0, 0, 1]]), {10: 0, 11: 1, 12: 2, 20: 3},
     {0: (10, 11, 12), 1: (20,)}, None),
    (np.array([[1, 0]]), {1: 0, 2: 1}, {0: (1, 2)}, None),  # a tie rounds up
    (np.random.default_rng(0).integers(0, 2, (50, 6)).astype(np.float32),
     {q: q for q in range(6)}, {0: (0, 1), 1: (2, 3, 4), 2: (5,)}, 4),
])
def test_unembed_samples(phys, cols, emb, n_vars):
    (ours, ofrac), (theirs, tfrac) = both("unembed_samples", phys, cols, emb, n_vars)
    np.testing.assert_array_equal(ours, theirs)
    assert ours.dtype == theirs.dtype and ofrac == tfrac


@pytest.mark.parametrize("writer,reader", [(te, je), (je, te)])
def test_embedding_cache_crosses_both_ways(tmp_path, writer, reader):
    """A directory one package writes serves the other: same file names,
    same pickled values."""
    emb = [te.clique_embedding_chimera(5, 4, cell_offset=(0, 0)),
           te.clique_embedding_chimera(5, 4, cell_offset=(2, 2))]
    key = f"clique_5_x2_{te.target_fingerprint(te.chimera_graph(4))}"
    writer.EmbeddingCache(tmp_path).put(key, emb)
    assert [p.name for p in tmp_path.iterdir()] == [f"embeddings_{key}.pkl"]
    assert reader.EmbeddingCache(tmp_path).get(key) == emb
    assert reader.EmbeddingCache(tmp_path).get("missing") is None
    again = tmp_path / "again"
    reader.EmbeddingCache(again).put(key, emb)
    assert (again / f"embeddings_{key}.pkl").read_bytes() == \
        (tmp_path / f"embeddings_{key}.pkl").read_bytes()
    assert pickle.loads((again / f"embeddings_{key}.pkl").read_bytes()) == emb


def test_embedding_cache_without_a_directory_keeps_memory_only():
    c = te.EmbeddingCache(None)
    c.put("k", [{0: (1,)}])
    assert c.get("k") == [{0: (1,)}] and c.cache_dir is None
