"""The QPU seam: adapters from a dimod-style sampler to the Sampler
protocol (the port's counterpart of ``qbmx.samplers.qpu``).

:class:`QPUSampler` wraps any object with ``sample_qubo(dict,
num_reads=...) -> sampleset`` (``record.sample``, ``variables``,
optionally ``record.num_occurrences`` and ``info["timing"]``), retries a
connection failure once after ``refresh``, and can pack ``copies``
replicas of a QUBO block-diagonally into one call.
:class:`StructuredQPUSampler` targets a structured sampler (one that only
takes problems already mapped onto its hardware graph) and runs the
embedding itself (:mod:`qbmx_torch.embedding`), one search per QUBO
structure.  There is no hard dependency on D-Wave's Ocean SDK: building
from a solver name try-imports ``dwave.system`` and raises with guidance
when it is absent.

Both adapters run on the host, one ``sample_qubo`` roundtrip a problem:
the QUBO batch is pulled to the host and the logical samples are returned
on its device.  The seed sweeps refuse them (``jit_safe = False``, the
flag and message ``qbmx``'s sweeps use).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from qbmx_torch import embedding as emb_mod

_CONNECTION_ERRORS = (
    ConnectionError,
    ConnectionResetError,
    ConnectionAbortedError,
    ConnectionRefusedError,
)


def _qubo_dict(Q: np.ndarray) -> dict:
    """Dense (n, n) float32 → sparse upper-triangular ``{(i, j): v}`` dict
    (dimod's BQM input).  Lower-triangle entries fold into the upper
    triangle (``Q[i,j] + Q[j,i]``), as ``split_qubo`` sums both triangles
    for the on-device samplers; every variable stays present."""
    n = Q.shape[-1]
    Qf = np.triu(Q + Q.T) - np.diag(np.diag(Q))  # fold, keep diag once
    ii, jj = np.nonzero(Qf)
    d = {(int(i), int(j)): float(Qf[i, j]) for i, j in zip(ii, jj)}
    for v in range(n):
        d.setdefault((v, v), 0.0)
    return d


def _ordered_samples(sampleset, n: int) -> np.ndarray:
    """(reads, n) float32 with columns in variable order 0..n-1 whatever the
    sampleset's own order.  Rows are expanded by ``record.num_occurrences``
    when present: annealers default to ``answer_mode='histogram'``, whose
    unique rows taken as they are would under-deliver reads and weight
    every distinct state once."""
    rec = np.asarray(sampleset.record.sample, dtype=np.float32)
    occ = getattr(getattr(sampleset, "record", None), "num_occurrences", None)
    if occ is not None:
        occ = np.asarray(occ).astype(np.int64).ravel()
        if occ.size == rec.shape[0] and (occ != 1).any():
            rec = np.repeat(rec, occ, axis=0)
    variables = list(getattr(sampleset, "variables", range(n)))
    order = np.argsort(np.asarray(variables))
    return rec[:, order]


def _pad_reads(out: np.ndarray, num_reads: int, generator: torch.Generator | None) -> np.ndarray:
    """Exactly ``num_reads`` rows.  A surplus is sliced off.  A short
    delivery keeps its rows and fills the rest by drawing delivered rows
    uniformly with replacement from ``generator``: reads are exchangeable,
    and unlike ``qbmx``'s cycling, no row is weighted above the others
    when ``num_reads`` is not a multiple of the delivered count."""
    got = out.shape[0]
    if got >= num_reads:
        return out[:num_reads]
    if got == 0:
        raise RuntimeError(
            "sampler delivered zero reads — cannot satisfy the requested "
            f"num_reads={num_reads}")
    src = generator.device if generator is not None else "cpu"
    idx = torch.randint(0, got, (num_reads - got,), generator=generator, device=src)
    return np.concatenate([out, out[idx.cpu().numpy()]])


class QPUSampler:
    """Adapter from a dimod-style sampler to the Sampler protocol.

    ``sampler`` needs ``sample_qubo(dict, num_reads=...) -> sampleset``;
    ``refresh`` (optional) returns a fresh sampler after a connection
    failure, before the one retry.  ``copies`` > 1 packs that many
    replicas of each QUBO block-diagonally into ONE ``sample_qubo`` call
    (the replicas share no couplings, so each hardware read gives
    ``copies`` independent samples), asks for ``ceil(num_reads / copies)``
    reads and de-interleaves them read-major.  ``qpu_time_used`` (µs, from
    ``info["timing"]["qpu_access_time"]``), ``reads_requested`` and
    ``samples_returned`` count what the adapter did."""

    #: each sample is a network roundtrip: the seed sweeps refuse it
    jit_safe = False

    def __init__(self, sampler, refresh=None, copies: int = 1, **sample_params):
        if copies < 1:
            raise ValueError(f"copies must be >= 1, got {copies}")
        self.sampler = sampler
        self.refresh = refresh
        self.copies = int(copies)
        self.sample_params = dict(sample_params)
        self.qpu_time_used = 0.0
        self.reads_requested = 0
        self.samples_returned = 0

    @classmethod
    def from_ocean(cls, solver_name: str = "Advantage_system4.1", token: str | None = None,
                   **sample_params) -> "QPUSampler":
        """Build from a D-Wave solver name through the Ocean SDK, the
        embedding left to ``EmbeddingComposite``."""
        try:
            from dwave.system import DWaveSampler, EmbeddingComposite
        except ImportError as e:
            raise NotImplementedError(
                f"QPU solver {solver_name!r} needs the Ocean SDK (dwave-system), "
                "which qbmx_torch deliberately does not depend on. Install it, or pass "
                "any dimod-style sampler object to QPUSampler(sampler=...)."
            ) from e

        def make():
            kw = {"solver": solver_name}
            if token:
                kw["token"] = token
            return EmbeddingComposite(DWaveSampler(**kw))

        adapter = cls(make(), **sample_params)
        adapter.refresh = make
        return adapter

    # -- sampling -------------------------------------------------------------

    def _call(self, qdict: dict, num_reads: int, n_vars: int) -> np.ndarray:
        """One ``sample_qubo`` roundtrip, retried once after ``refresh`` on
        a connection error, with the QPU time counted."""
        try:
            ss = self.sampler.sample_qubo(qdict, num_reads=int(num_reads), **self.sample_params)
        except _CONNECTION_ERRORS:
            if self.refresh is not None:
                self.sampler = self.refresh()
            ss = self.sampler.sample_qubo(qdict, num_reads=int(num_reads), **self.sample_params)
        timing = getattr(ss, "info", {}).get("timing", {})
        self.qpu_time_used += float(timing.get("qpu_access_time", 0.0))
        self.reads_requested += int(num_reads)
        return _ordered_samples(ss, n_vars)

    def _sample_one(self, Q: np.ndarray, num_reads: int, generator) -> np.ndarray:
        n = Q.shape[-1]
        k = min(self.copies, num_reads)  # never anneal more copies than reads
        if k <= 1:
            out = _pad_reads(self._call(_qubo_dict(Q), num_reads, n), num_reads, generator)
            self.samples_returned += out.shape[0]
            return out
        # replica c owns variables [c*n, (c+1)*n)
        base = _qubo_dict(Q)
        packed = {(i + c * n, j + c * n): v for c in range(k) for (i, j), v in base.items()}
        rec = self._call(packed, -(-num_reads // k), k * n)
        # read r, replica c → sample r*k + c; reshaped by the rows delivered,
        # which may be more (an expanded histogram) or fewer than asked for
        got = rec.shape[0]
        out = _pad_reads(rec.reshape(got, k, n).reshape(got * k, n), num_reads, generator)
        self.samples_returned += out.shape[0]
        return out

    def sample_batch(self, generator, Q: torch.Tensor, num_reads: int) -> torch.Tensor:
        """(B, n, n) QUBOs → (B, num_reads, n), one roundtrip a problem."""
        Qh = Q.detach().cpu().numpy().astype(np.float32)
        out = np.stack([self._sample_one(Qh[b], num_reads, generator)
                        for b in range(Qh.shape[0])])
        return torch.from_numpy(out).to(Q.device)


class StructuredQPUSampler(QPUSampler):
    """QPU adapter that owns the embedding: it targets a STRUCTURED sampler
    (``nodelist``/``edgelist`` or ``adjacency``; a raw ``DWaveSampler``
    qualifies) and maps each QUBO onto the hardware graph itself.

    * **One embedding search per QUBO structure**, kept in memory and, with
      ``cache_dir``, on disk; the key is (kind, n, copies, chip
      fingerprint).  ``embedding_searches`` counts the searches made.
    * **Partition-aware ``copies``**: replicas go to disjoint chip regions
      — translated Chimera cell blocks on a declared Chimera topology, each
      verified against the real adjacency so defective blocks are skipped,
      else one escalating search per :func:`~qbmx_torch.embedding.partition_target`
      region.  When fewer regions embed than asked for, the found count is
      used, with a warning.
    * Chains encoded per call (couplings split over the available
      couplers, a ferromagnetic chain penalty) and decoded by majority
      vote; ``chain_break_fraction`` is the running share of (read,
      variable) cells whose chain disagreed.

    ``topology``: ``("chimera", m, n, t)`` or a D-Wave-style properties
    entry; ``None`` reads ``sampler.properties["topology"]``, and an
    unknown chip (Pegasus included) takes the heuristic path.
    """

    def __init__(self, sampler, refresh=None, copies: int = 1,
                 chain_strength: float | None = None, cache_dir=None, topology=None,
                 seed: int = 0, target_adj: dict | None = None, **sample_params):
        super().__init__(sampler, refresh=refresh, copies=copies, **sample_params)
        if target_adj is None:
            if hasattr(sampler, "adjacency"):
                target_adj = {int(q): set(map(int, nbrs))
                              for q, nbrs in sampler.adjacency.items()}
            elif hasattr(sampler, "edgelist"):
                target_adj = emb_mod.adjacency_from_edgelist(
                    sampler.edgelist, getattr(sampler, "nodelist", None))
            else:
                raise TypeError(
                    "StructuredQPUSampler needs a structured sampler "
                    "(nodelist/edgelist or adjacency) or an explicit "
                    "target_adj; for composite samplers that embed "
                    "internally use QPUSampler instead.")
        self._adj = target_adj
        self._fp = emb_mod.target_fingerprint(target_adj)
        self._topology = self._parse_topology(topology, sampler)
        self.chain_strength = chain_strength
        self.seed = int(seed)
        self._cache = emb_mod.EmbeddingCache(cache_dir)
        self.embedding_searches = 0
        self._cb_broken = 0
        self._cb_cells = 0

    @staticmethod
    def _parse_topology(topology, sampler):
        if topology is None:
            props = getattr(sampler, "properties", None) or {}
            topology = props.get("topology")
        if topology is None:
            return None
        if isinstance(topology, dict):
            if str(topology.get("type", "")).lower() != "chimera":
                return None  # pegasus, zephyr, ...: the heuristic path
            shape = list(topology.get("shape", ()))
            if len(shape) == 3:
                return ("chimera", int(shape[0]), int(shape[1]), int(shape[2]))
            return None
        kind, *shape = topology
        if str(kind).lower() != "chimera" or len(shape) != 3:
            return None
        return ("chimera", int(shape[0]), int(shape[1]), int(shape[2]))

    @property
    def chain_break_fraction(self) -> float:
        """Running fraction of (read, variable) cells whose chain broke."""
        return self._cb_broken / float(max(self._cb_cells, 1))

    @classmethod
    def from_ocean(cls, solver_name: str = "Advantage_system4.1", token: str | None = None,
                   copies: int = 1, cache_dir=None, **sample_params) -> "StructuredQPUSampler":
        """Build around a raw (structured) ``DWaveSampler`` through the
        Ocean SDK; the adapter embeds and caches."""
        try:
            from dwave.system import DWaveSampler
        except ImportError as e:
            raise NotImplementedError(
                f"QPU solver {solver_name!r} needs the Ocean SDK (dwave-system), "
                "which qbmx_torch deliberately does not depend on. Install it, or pass "
                "any structured dimod-style sampler to "
                "StructuredQPUSampler(sampler=...)."
            ) from e

        def make():
            kw = {"solver": solver_name}
            if token:
                kw["token"] = token
            return DWaveSampler(**kw)

        adapter = cls(make(), copies=copies, cache_dir=cache_dir, **sample_params)
        adapter.refresh = make
        return adapter

    # -- embedding lifecycle ---------------------------------------------------

    def _embeddings_for(self, n: int, diag_only: bool) -> list[dict]:
        kind = "diag" if diag_only else "clique"
        key = f"{kind}_{n}_x{self.copies}_{self._fp}"
        cached = self._cache.get(key)
        if cached is not None:
            return cached
        embs = self._compute_embeddings(n, diag_only)
        self._cache.put(key, embs)
        return embs

    def _compute_embeddings(self, n: int, diag_only: bool) -> list[dict]:
        """One structure computation (counted once however many replicas it
        places).  Raises when the problem cannot fit the chip at all."""
        self.embedding_searches += 1
        if diag_only:
            # no couplings: chains of one qubit, replicas on disjoint slices
            qubits = sorted(self._adj)
            k = max(min(self.copies, len(qubits) // n), 1)
            if n > len(qubits):
                raise RuntimeError(
                    f"cannot embed {n} variables into a {len(qubits)}-qubit chip")
            embs = [{v: (qubits[c * n + v],) for v in range(n)} for c in range(k)]
        elif self._topology is not None:
            _, m, ncols, t = self._topology
            A = -(-n // t)
            # a declared topology does not promise every qubit and coupler:
            # each candidate block is verified against the real adjacency
            clique = [(u, v) for u in range(n) for v in range(u + 1, n)]
            embs = []
            for br in range(m // A if A else 0):
                if len(embs) == self.copies:
                    break
                for bc in range(ncols // A if A else 0):
                    if len(embs) == self.copies:
                        break
                    e = emb_mod.clique_embedding_chimera(n, m, ncols, t,
                                                         cell_offset=(br * A, bc * A))
                    if e is not None and not emb_mod.verify_embedding(e, clique, self._adj):
                        embs.append(e)
            if not embs:  # K_n beyond the clique construction → heuristic
                embs = self._heuristic_embeddings(n)
        else:
            embs = self._heuristic_embeddings(n)
        if not embs:
            raise RuntimeError(
                f"could not embed a {n}-variable QUBO into the "
                f"{len(self._adj)}-qubit target graph (problem oversized "
                "for this chip)")
        if len(embs) < self.copies:
            warnings.warn(
                f"found embeddings for {len(embs)} of {self.copies} requested "
                "copies; continuing with fewer parallel replicas", stacklevel=2)
        return embs

    def _heuristic_embeddings(self, n: int) -> list[dict]:
        clique = [(u, v) for u in range(n) for v in range(u + 1, n)]
        if self.copies == 1:
            e = emb_mod.escalating_find_embedding(clique, self._adj, variables=range(n),
                                                  seed=self.seed)
            return [e] if e is not None else []
        regions = emb_mod.partition_target(self._adj, self.copies, seed=self.seed)
        embs = []
        for i, region in enumerate(regions):
            e = emb_mod.escalating_find_embedding(
                clique, emb_mod.subgraph(self._adj, region), variables=range(n),
                seed=self.seed + i)
            if e is not None:
                embs.append(e)
        if not embs:  # regions too small one by one → the whole chip
            e = emb_mod.escalating_find_embedding(clique, self._adj, variables=range(n),
                                                  seed=self.seed)
            if e is not None:
                embs.append(e)
        return embs

    # -- sampling ---------------------------------------------------------------

    def _sample_one(self, Q: np.ndarray, num_reads: int, generator) -> np.ndarray:
        n = Q.shape[-1]
        qdict = _qubo_dict(Q)
        diag_only = not any(v for (i, j), v in qdict.items() if i != j)
        embs = self._embeddings_for(n, diag_only)
        k = min(len(embs), self.copies, num_reads)
        embs = embs[:k]
        cs = (self.chain_strength if self.chain_strength is not None
              else emb_mod.chain_strength_for(qdict))
        phys: dict = {}
        for e in embs:
            phys.update(emb_mod.embed_qubo(qdict, e, self._adj, cs))
        used = sorted({q for ij in phys for q in ij})
        col = {q: c for c, q in enumerate(used)}
        rec = self._call(phys, -(-num_reads // k), len(used))  # (got, n_used), qubit order
        got = rec.shape[0]
        logical = []
        for e in embs:
            dec, frac = emb_mod.unembed_samples(rec, col, e, n)
            logical.append(dec)
            self._cb_broken += int(round(frac * got * n))
            self._cb_cells += got * n
        # read r, replica c → sample r*k + c
        out = _pad_reads(np.stack(logical, axis=1).reshape(got * k, n), num_reads, generator)
        self.samples_returned += out.shape[0]
        return out
