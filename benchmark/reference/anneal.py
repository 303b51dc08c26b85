"""Plain annealers: single-flip Metropolis on a geometric schedule (the
"SA" solver) and parallel tempering with heat-bath sweeps (the "PT"
solver), over G groups of B problems that share their couplings.

A problem is ``(h, U)``: linear terms h (n,) and strictly upper couplings
U (n, n); the energy of s in {0,1}^n is ``h·s + Σ_{i<j} U_ij s_i s_j``, so
the local field of unit i is ``h_i + Σ_j J_ij s_j`` with ``J = U + Uᵀ``.

The semantics are dwave-neal's and the reference QBM code's: per problem
the default range (hot: ln 2 over the stiffest unit's largest energy
change; cold: ln 100 over the smallest nonzero magnitude of h or J; cold ≥
hot·1.0001; 0.1 and 10 where a problem gives none), a random initial
state, and each sweep visits units 0..n−1 in order.  Metropolis flips unit
i iff ``(1 − 2 s_i)·field < −log(u)/β``.  A ladder of M rungs runs on a
geometric grid from ``min(hot, β_t/2)`` to ``β_t``; each rung sets unit i
to 1 iff ``field < (log(1 − u) − log u)/β`` (heat bath), then the links
(m, m+1) with ``m % 2 == sweep % 2`` swap states iff ``(β_{m+1} − β_m)·(E_m
− E_{m+1}) < −log(u)``; the top rung is read.

Units whose couplings leave them independent within a sweep are updated
together: unit i goes in the wave after every coupled unit j < i
(:func:`waves`), which gives each unit exactly the states it sees in the
ordered sweep, so the waves are the sweep, not an approximation of it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.precision import FP32, Precision


def waves(U: torch.Tensor) -> list[torch.Tensor]:
    """The units of an ordered sweep grouped into waves that may update
    together: unit i's wave is one past the latest wave of a unit j < i
    that any group couples it to."""
    nz = (U != 0).any(0).cpu().numpy()
    adj = nz | nz.T
    n = adj.shape[0]
    wave = np.zeros(n, dtype=np.int64)
    for i in range(n):
        js = np.flatnonzero(adj[i, :i])
        wave[i] = wave[js].max() + 1 if js.size else 0
    return [torch.as_tensor(np.flatnonzero(wave == w), device=U.device)
            for w in range(int(wave.max()) + 1)]


def symmetric(U: torch.Tensor) -> torch.Tensor:
    return U + U.transpose(-1, -2)


def beta_range(h: torch.Tensor, J: torch.Tensor):
    """Per-problem (hot, cold) of the default schedule; ``h`` (G, B, n),
    ``J`` (G, n, n) symmetric."""
    absJ = J.abs()
    max_delta = (h.abs() + absJ.sum(-1)[:, None, :]).amax(-1)
    inf = torch.tensor(float("inf"), device=h.device)
    h_min = torch.where(h.abs() > 0, h.abs(), inf).amin(-1)
    j_min = torch.where(absJ > 0, absJ, inf).flatten(-2).amin(-1)[:, None]
    min_delta = torch.minimum(h_min, j_min)
    hot = torch.where(max_delta > 0, math.log(2.0) / max_delta.clamp_min(1e-12),
                      torch.full_like(max_delta, 0.1))
    cold = torch.where(torch.isfinite(min_delta), math.log(100.0) / min_delta.clamp_min(1e-12),
                       torch.full_like(min_delta, 10.0))
    return hot, torch.maximum(cold, hot * 1.0001)


def energies(h: torch.Tensor, J: torch.Tensor, s: torch.Tensor,
             dtype=torch.float64) -> torch.Tensor:
    """Energies (G, B, ...) of states ``s`` (G, B, ..., n) under problems
    ``h`` (G, B, n), ``J`` (G, n, n), in ``dtype``."""
    G, B, n = h.shape
    s, h, J = s.to(dtype), h.to(dtype), J.to(dtype)
    sJ = torch.matmul(s.reshape(G, -1, n), J).reshape(s.shape)
    lin = (s * h.reshape((G, B) + (1,) * (s.dim() - 3) + (n,))).sum(-1)
    return lin + 0.5 * (s * sJ).sum(-1)


def _plan(h: torch.Tensor, Jr: torch.Tensor, U: torch.Tensor, extra: int):
    """Per wave: its units, their couplings' columns (G, n, k) and their
    linear terms shaped to broadcast over ``extra`` chain axes."""
    G, B = h.shape[:2]
    return [(idx, Jr[:, :, idx].contiguous(),
             h[..., idx].reshape((G, B) + (1,) * extra + (len(idx),)))
            for idx in waves(U)]


def _fields(s, J_w, h_w):
    """Local fields (G, B, ..., k) of a wave's units in every chain of ``s``."""
    G, n = s.shape[0], s.shape[-1]
    f = torch.matmul(s.reshape(G, -1, n), J_w)
    return f.reshape(s.shape[:-1] + (J_w.shape[-1],)).add_(h_w)


def anneal_sa(h: torch.Tensor, U: torch.Tensor, reads: int, sweeps: int,
              generator: torch.Generator, prec: Precision = FP32) -> torch.Tensor:
    """Metropolis anneal of ``h`` (G, B, n) with couplings ``U`` (G, n, n):
    (G, B, reads, n) final states."""
    G, B, n = h.shape
    dev = h.device
    J = symmetric(U)
    hot, cold = beta_range(h, J)
    logr = torch.log(cold / hot)
    s = (torch.rand((G, B, reads, n), generator=generator, device=dev) < 0.5).float()
    span = 1.0 / (sweeps - 1) if sweeps > 1 else 0.0
    plan = _plan(h, prec.round(J), U, 1)
    for t in range(sweeps):
        beta = cold if sweeps == 1 else hot * torch.exp(logr * (t * span))
        thr = torch.rand((G, B, reads, n), generator=generator, device=dev).log_().neg_() \
            .div_(beta[:, :, None, None])
        for idx, J_w, h_w in plan:
            si = s.index_select(-1, idx)
            f = _fields(s, J_w, h_w)
            delta = torch.addcmul(f, si, f, value=-2.0)  # a flip's energy change, (1 - 2 s_i)·f
            flip = delta < thr.index_select(-1, idx)
            s.index_copy_(-1, idx, torch.where(flip, 1.0 - si, si))
    return s


def ladder(h: torch.Tensor, J: torch.Tensor, rungs: int, beta_target: float):
    """Per-problem rung inverse temperatures (G, B, M)."""
    hot, _ = beta_range(h, J)
    bt = torch.tensor(beta_target, device=h.device)
    beta_hot = torch.minimum(hot, bt * 0.5)
    t = torch.arange(rungs, device=h.device, dtype=torch.float32) / max(rungs - 1, 1)
    log_hot = torch.log(beta_hot)[..., None]
    return torch.exp(log_hot + t * (torch.log(bt) - log_hot))


def anneal_pt(h: torch.Tensor, U: torch.Tensor, reads: int, sweeps: int, rungs: int,
              generator: torch.Generator, beta_target: float = 1.0,
              prec: Precision = FP32) -> torch.Tensor:
    """Parallel tempering of ``h`` (G, B, n) with couplings ``U`` (G, n, n):
    (G, B, reads, n) states of the top rung."""
    G, B, n = h.shape
    M, dev = rungs, h.device
    J = symmetric(U)
    betas = ladder(h, J, M, beta_target)
    dbeta = betas[..., 1:] - betas[..., :-1]
    Jr = prec.round(J)
    s = (torch.rand((G, B, M, reads, n), generator=generator, device=dev) < 0.5).float()
    plan = _plan(h, Jr, U, 2)
    for t in range(sweeps):
        u = torch.rand((G, B, M, reads, n), generator=generator, device=dev)
        thr = (torch.log1p(-u) - torch.log(u)).div_(betas[..., None, None])
        for idx, J_w, h_w in plan:
            s.index_copy_(-1, idx, (_fields(s, J_w, h_w) < thr.index_select(-1, idx)).float())
        if t % 2 >= M - 1:
            continue
        lo = torch.arange(t % 2, M - 1, 2, device=dev)
        E = energies(h, Jr, s, torch.float32)
        dE = E[:, :, lo] - E[:, :, lo + 1]
        usw = torch.rand((G, B, len(lo), reads), generator=generator, device=dev)
        swap = (dbeta[:, :, lo, None] * dE < -torch.log(usw))[..., None]
        s_lo, s_hi = s[:, :, lo], s[:, :, lo + 1]
        s[:, :, lo] = torch.where(swap, s_hi, s_lo)
        s[:, :, lo + 1] = torch.where(swap, s_lo, s_hi)
    return s[:, :, M - 1]


def anneal(solver: str, h: torch.Tensor, U: torch.Tensor, reads: int, sweeps: int,
           generator: torch.Generator, rungs: int = 1, prec: Precision = FP32):
    """The annealer a solver name stands for."""
    if solver == "SA":
        return anneal_sa(h, U, reads, sweeps, generator, prec)
    if solver == "PT":
        return anneal_pt(h, U, reads, sweeps, rungs, generator, prec=prec)
    raise ValueError(f"no reference annealer for solver {solver!r}")
