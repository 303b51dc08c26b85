"""Sampler interface and solver-string registry (the counterpart of
``qbmx.samplers.api``: SA, BMS, PT, the exact oracle, the native host
annealer and the QPU adapters).

A sampler is a small config object with

    sample_batch(generator, Q, num_reads) -> (B, num_reads, n) float32 in {0,1}

for a batch ``Q`` (B, n, n) of dense QUBOs, and optionally
``sample_groups(generator, Q_shared, h_extra, num_reads)`` for the
structured shared-coupling form every model uses.  Routing is by tensor
device: ``"SA"``/``"SA-PALLAS"``, ``"BMS"`` and ``"PT"`` launch their CUDA
kernel on CUDA tensors and run its plain version on CPU tensors;
``"SA-JAX"`` (alias ``"SA-TORCH"``) always runs the plain version.
``"SA-NATIVE"`` anneals on the host in C++ (``samplers/native.py``) on
either device; a D-Wave solver name (``ADVANTAGE*``, ``DW_*``) builds a QPU
adapter through the Ocean SDK (``samplers/qpu.py``), which raises with
guidance where the SDK is not installed.
"""

from __future__ import annotations

import dataclasses
from typing import Protocol

import torch

from qbmx_torch.core.qubo import densify_groups
from qbmx_torch.samplers import exact as _exact
from qbmx_torch.samplers import gibbs_cuda, pt_wide_cuda, sa_cuda, sa_torch
from qbmx_torch.samplers.native import NativeSASampler
from qbmx_torch.samplers.qpu import QPUSampler, StructuredQPUSampler
from qbmx_torch.utils.spans import span, spanned


class Sampler(Protocol):
    def sample_batch(self, generator: torch.Generator | None, Q: torch.Tensor,
                     num_reads: int) -> torch.Tensor:
        """(B, n, n) QUBOs → (B, num_reads, n) binary samples."""
        ...


def sampler_sample_groups(sampler, generator, Q_shared, h_extra, num_reads):
    """Structured sampling → (G, B, num_reads, n): the sampler's own
    ``sample_groups`` when it has one, else ``sample_batch`` on the
    densified batch.  Every model reaches the sampler layer here, so the
    ``sampler`` span is opened here."""
    with span("sampler"):
        fn = getattr(sampler, "sample_groups", None)
        if fn is not None:
            return fn(generator, Q_shared, h_extra, num_reads)
        G, B, n = h_extra.shape
        flat = sampler.sample_batch(generator, densify_groups(Q_shared, h_extra), num_reads)
        return flat.reshape(G, B, num_reads, n)


@dataclasses.dataclass(frozen=True)
class SASampler:
    """Annealed Metropolis sampler (neal-equivalent).  ``num_sweeps`` is the
    reference's ``anneal_steps``; ``use_kernel=False`` forces the plain
    PyTorch version on every device; ``dense_couplings``: the structured
    calls' J_g is known dense (``wide_cuda.launch``)."""

    num_sweeps: int = 1000
    use_kernel: bool = True
    dense_couplings: bool = False

    @spanned("sampler.wrapper")
    def sample_batch(self, generator, Q, num_reads):
        fn = sa_cuda.sa_sample_batch_cuda if self.use_kernel else sa_torch.sa_sample_batch_plain
        return fn(Q, num_reads, self.num_sweeps, generator=generator)

    @spanned("sampler.wrapper")
    def sample_groups(self, generator, Q_shared, h_extra, num_reads):
        if not self.use_kernel:
            return sa_torch.sa_sample_groups_plain(Q_shared, h_extra, num_reads,
                                                   self.num_sweeps, generator=generator)
        return sa_cuda.sa_sample_groups_cuda(Q_shared, h_extra, num_reads, self.num_sweeps,
                                             generator=generator,
                                             dense_couplings=self.dense_couplings)


@dataclasses.dataclass(frozen=True)
class GibbsSampler:
    """Annealed heat-bath sampler — the "BMS" solver: each read is a chain
    warmed up over ``num_warmup`` sweeps from ``min(default_hot, beta)`` to
    ``beta``, then read out once.

    ``pair_updates``: draw consecutive variable pairs from their exact
    4-state conditional.  ``None`` (the default) means pairs where the
    kernel runs (CUDA tensors) and single-variable sweeps on the plain
    route, as ``qbmx``'s kernel and XLA routes do.  ``quad_updates=True``
    draws variable quadruples from their exact 16-state conditional on both
    routes and both entries, and wins over ``pair_updates``.
    ``dense_couplings`` as :class:`SASampler`'s."""

    num_warmup: int = 64
    beta: float = 1.0
    pair_updates: bool | None = None
    quad_updates: bool | None = None
    dense_couplings: bool = False

    def widths(self, on_kernel: bool) -> tuple[bool, bool]:
        """``(pair, quad)`` on the kernel route or the plain one."""
        quad = self.quad_updates is True
        pair = not quad and (self.pair_updates is not False if on_kernel
                             else bool(self.pair_updates))
        return pair, quad

    @spanned("sampler.wrapper")
    def sample_batch(self, generator, Q, num_reads):
        pair, quad = self.widths(Q.device.type == "cuda")
        return gibbs_cuda.gibbs_sample_batch_cuda(
            Q, num_reads, self.num_warmup, generator=generator, beta=self.beta, pair=pair,
            quad=quad)

    @spanned("sampler.wrapper")
    def sample_groups(self, generator, Q_shared, h_extra, num_reads):
        pair, quad = self.widths(Q_shared.device.type == "cuda")
        return gibbs_cuda.gibbs_sample_groups_cuda(
            Q_shared, h_extra, num_reads, self.num_warmup, generator=generator,
            beta=self.beta, pair=pair, quad=quad, dense_couplings=self.dense_couplings)


@dataclasses.dataclass(frozen=True)
class PTSampler:
    """Parallel-tempering (replica exchange) sampler at ``beta_target``:
    per read, ``num_replicas`` rungs on a geometric β grid run heat-bath
    sweeps with alternating-parity exchanges, and the target rung is read
    out.  On CUDA tensors ``pt_wide_cuda.pt_route`` picks the kernel: K3 on
    the densified batch where it holds J_b in shared memory, else K5 on the
    structured form (a dense batch is G = B groups of one).  On CPU
    tensors both entries run the plain version on the densified batch, as
    ``qbmx`` densifies every structured PT call."""

    num_sweeps: int = 64
    num_replicas: int = 8
    beta_target: float = 1.0

    @spanned("sampler.wrapper")
    def sample_batch(self, generator, Q, num_reads):
        return pt_wide_cuda.pt_sample_batch(
            Q, num_reads, self.num_sweeps, num_replicas=self.num_replicas,
            beta_target=self.beta_target, generator=generator)

    @spanned("sampler.wrapper")
    def sample_groups(self, generator, Q_shared, h_extra, num_reads):
        return pt_wide_cuda.pt_sample_groups(
            Q_shared, h_extra, num_reads, self.num_sweeps, num_replicas=self.num_replicas,
            beta_target=self.beta_target, generator=generator)


@dataclasses.dataclass(frozen=True)
class ExactSampler:
    """Exact enumeration oracle (n ≤ 20) — the test anchor."""

    beta: float = 1.0

    def sample_batch(self, generator, Q, num_reads):
        return torch.stack([_exact.exact_sample(generator, q, num_reads, self.beta)
                            for q in Q])


def with_dense_couplings(sampler, dense: bool):
    """``sampler`` told that its structured calls' J_g is dense
    (``dense_couplings``) where it is an SA or BMS sampler and ``dense``;
    any other sampler as it is."""
    if dense and isinstance(sampler, (SASampler, GibbsSampler)):
        return dataclasses.replace(sampler, dense_couplings=True)
    return sampler


def get_sampler(solver: str, num_sweeps: int = 1000, **kwargs) -> Sampler:
    """Solver-string registry; ``num_sweeps`` is sweeps per read for every
    solver (SA anneal sweeps, BMS warm-up sweeps, PT sweeps).  The legacy
    ``num_warmup`` kwarg overrides it for BMS and PT, as in ``qbmx``."""
    s = solver.upper()
    if s in ("SA", "SA-PALLAS"):
        return SASampler(num_sweeps=num_sweeps)
    if s in ("SA-JAX", "SA-TORCH"):
        return SASampler(num_sweeps=num_sweeps, use_kernel=False)
    if s == "SA-NATIVE":
        return NativeSASampler(num_sweeps=num_sweeps)
    if s == "BMS":
        return GibbsSampler(num_warmup=kwargs.get("num_warmup", num_sweeps),
                            beta=kwargs.get("beta", 1.0),
                            pair_updates=kwargs.get("pair_updates"),
                            quad_updates=kwargs.get("quad_updates"))
    if s == "PT":
        return PTSampler(num_sweeps=kwargs.get("num_warmup", num_sweeps),
                         num_replicas=kwargs.get("num_replicas", 8),
                         beta_target=kwargs.get("beta", 1.0))
    if s == "EXACT":
        return ExactSampler(beta=kwargs.get("beta", 1.0))
    if s.startswith(("ADVANTAGE", "DW_")):
        # ``embedding="first_party"`` (the default) wraps the raw structured
        # sampler and embeds with qbmx_torch.embedding; ``"composite"``
        # leaves the embedding to Ocean's EmbeddingComposite
        if kwargs.get("embedding", "first_party") == "composite":
            return QPUSampler.from_ocean(solver, token=kwargs.get("token"),
                                         copies=kwargs.get("copies", 1))
        return StructuredQPUSampler.from_ocean(
            solver, token=kwargs.get("token"), copies=kwargs.get("copies", 1),
            cache_dir=kwargs.get("cache_dir"), chain_strength=kwargs.get("chain_strength"))
    if s == "FUJITSUDAU":
        raise NotImplementedError(
            f"QPU solver {solver!r}: qbmx_torch is annealer-free by design. Pass any "
            "dimod-style sampler to qbmx_torch.samplers.qpu.QPUSampler to adapt "
            "external hardware.")
    raise ValueError(
        f'Unknown solver {solver!r}. Valid: "SA", "SA-JAX" ("SA-TORCH"), "SA-PALLAS", '
        '"SA-NATIVE", "BMS", "PT", "EXACT", or a D-Wave solver name with the Ocean SDK '
        "installed.")
