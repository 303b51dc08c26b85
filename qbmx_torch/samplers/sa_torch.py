"""Annealed single-flip Metropolis in plain PyTorch — the plain version of
the CUDA kernel ``qbmx_torch/csrc/sa_metropolis.cu``.

Counterpart of ``qbmx.samplers.sa_jax`` and of the two TPU kernels'
Metropolis mode (``qbmx.samplers.sa_lane._lane_kernel`` over the structured
form, ``qbmx.samplers.sa_pallas._sa_kernel`` over a dense batch).  The
semantics are the kernels': per problem a geometric schedule
``β_t = hot·exp(logr·t/(S−1))``; per sweep one uniform per (variable, chain)
turned into the threshold ``−log(u)/β``; variables visited 0..n−1, each
flipping iff ``(1 − 2s)·field < threshold``; a random {0,1} initial state.

The structured form is the one every model uses: G groups of B problems,
group ``g`` sharing couplings ``J_g`` while problem ``(g, b)`` has linear
terms ``diag(Q_shared[g]) + h_extra[g, b]``.  A dense batch is G = B groups
of one problem each.

``philox_variates`` and ``pt_philox_variates`` write out on the host the
Philox draws of the three kernels (``sa_metropolis.cu``,
``sa_heatbath.cu``, ``pt_heatbath.cu``) in generator mode.

``host_variates`` replaces the generator with host-supplied arrays of the
shapes of the JAX kernels' ``debug_randoms``, so the same arrays drive both
packages: structured ``(init01 (G,B,R,n), uniforms (S,G,B,n,R))``
(``sa_lane.py:441-444``), dense ``(init01 (B,R,n), uniforms (S,B,n,R))``
(``sa_pallas.py:733-737``).
"""

from __future__ import annotations

import numpy as np
import torch

from qbmx_torch.core.qubo import beta_range_from_parts, split_qubo
from qbmx_torch.core.rng import rand


def inv_span(num_sweeps: int) -> float:
    """float32 ``1/(S−1)`` (1 for a single sweep) — the schedule step the
    kernel and this version share, so ``t·inv_span`` rounds identically."""
    return float(np.float32(1.0 / max(num_sweeps - 1, 1)))


def schedule_params(h: torch.Tensor, J: torch.Tensor, num_sweeps: int,
                    beta_hot=None, beta_cold=None):
    """Per-problem ``(hot, logr)`` (G, B) of the geometric schedule.

    ``h`` (G, B, n) effective linear terms; ``J`` (G, 1, n, n) couplings.
    Missing endpoints default to :func:`beta_range_from_parts` on the
    effective per-problem QUBO (``sa_lane.py:463-488``, which equals
    ``default_beta_range`` on the densified batch, ``sa_pallas.py:739``);
    a single sweep runs cold (``sa_lane.py:485-486``)."""
    G, B = h.shape[:2]
    if beta_hot is None or beta_cold is None:
        d_hot, d_cold = beta_range_from_parts(h, J)
        beta_hot = d_hot if beta_hot is None else beta_hot
        beta_cold = d_cold if beta_cold is None else beta_cold
    as_gb = lambda v: torch.as_tensor(v, dtype=torch.float32, device=h.device).expand(G, B)
    beta_cold = as_gb(beta_cold)
    beta_hot = beta_cold if num_sweeps == 1 else as_gb(beta_hot)
    logr = torch.log(beta_cold / beta_hot)
    return beta_hot.contiguous(), logr.contiguous()


def metropolis_sweep(s: torch.Tensor, thr: torch.Tensor, h: torch.Tensor,
                     J: torch.Tensor) -> torch.Tensor:
    """One sweep over variables 0..n−1, batched over problems; updates
    ``s`` IN PLACE (one state buffer for the whole anneal) and returns it.

    ``s`` (..., R, n) states in {0,1}; ``thr`` (..., n, R) thresholds
    ``−log(u)/β``; ``h`` (..., n) linear terms; ``J`` (..., n, n) symmetric
    zero-diagonal couplings, broadcastable against ``s``'s leading dims."""
    for i in range(s.shape[-1]):
        field = h[..., i, None] + torch.matmul(s, J[..., i, :, None])[..., 0]  # (..., R)
        si = s[..., i]
        accept = (1.0 - 2.0 * si) * field < thr[..., i, :]
        s[..., i] = torch.where(accept, 1.0 - si, si)
    return s


_PHILOX_M = (np.uint64(0xD2511F53), np.uint64(0xCD9E8D57))
_PHILOX_W = (np.uint64(0x9E3779B9), np.uint64(0xBB67AE85))
_LO32 = np.uint64(0xFFFFFFFF)


def philox4x32_10(counter, key):
    """Philox4x32-10 (Salmon et al., SC'11) on numpy arrays: ``counter`` is
    four and ``key`` two broadcastable arrays of 32-bit words; returns the
    four output words as uint64 arrays.  The kernel's generator, written
    out for the host."""
    c = [np.asarray(w, np.uint64) for w in counter]
    k0, k1 = (np.asarray(w, np.uint64) for w in key)
    for _ in range(10):
        p0, p1 = _PHILOX_M[0] * c[0], _PHILOX_M[1] * c[2]  # < 2^64: exact
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ k0, p1 & _LO32,
             (p0 >> np.uint64(32)) ^ c[3] ^ k1, p0 & _LO32]
        k0, k1 = (k0 + _PHILOX_W[0]) & _LO32, (k1 + _PHILOX_W[1]) & _LO32
    return c


def _words(seed: int, streams, R: int, n: int, slot: int, y_base: int = 0):
    """(len(streams), R, n) uint64 Philox words of variables 0..n−1: key
    ``(seed low word, stream)``, counter ``(read, y_base | variable // 4,
    slot, seed high word)``, word ``variable % 4``."""
    nq = -(-n // 4)
    r = np.arange(R, dtype=np.uint64)[:, None]
    y = np.uint64(y_base) | np.arange(nq, dtype=np.uint64)[None, :]
    key = (np.uint64(seed & 0xFFFFFFFF), np.asarray(streams, np.uint64)[:, None, None])
    out = philox4x32_10((r, y, np.uint64(slot), np.uint64(seed >> 32)), key)
    words = np.stack(np.broadcast_arrays(*out), axis=-1)
    return words.reshape(len(streams), R, 4 * nq)[..., :n]


def _uniform(words):
    return (words >> np.uint64(8)).astype(np.float32) * np.float32(2.0**-24)


_INIT_SLOT = 0xFFFFFFFF  # sweep slot of the initial bits


def philox_variates(seed: int, G: int, B: int, R: int, n: int, S: int):
    """The ``(init01 (G,B,R,n), uniforms (S,G,B,n,R))`` float32 arrays the
    anneal kernels (``sa_metropolis.cu``, ``sa_heatbath.cu``) draw in
    generator mode from ``seed``: key ``(seed low word, problem g·B+b)``,
    counter ``(read, variable // 4, sweep, seed high word)`` with sweep slot
    2^32−1 for the initial bits; a bit is the low bit of a word, a uniform
    ``(word >> 8)·2^-24``."""
    streams = np.arange(G * B)
    init01 = (_words(seed, streams, R, n, _INIT_SLOT) & np.uint64(1)).astype(np.float32)
    uniforms = np.empty((S, G, B, n, R), np.float32)
    for t in range(S):
        uniforms[t] = _uniform(_words(seed, streams, R, n, t)).reshape(G, B, R, n) \
            .transpose(0, 1, 3, 2)
    return init01.reshape(G, B, R, n), uniforms


def pt_philox_variates(seed: int, B: int, M: int, R: int, n: int, S: int, var_shift: int = 8):
    """The ``(init01 (B·M,R,n), uniforms (S,B·M,n,R), swap_u (S,B·M,R))``
    float32 arrays the tempering kernels draw in generator mode from
    ``seed``, slot ``b·M + m``: key ``(seed low word, problem b)``; variable
    draws at counter ``(read, (m << var_shift) | variable // 4, sweep, seed
    high word)`` (sweep slot 2^32−1 for the initial bits); the swap uniform
    of rung m at counter ``(read, ((m // 4) << var_shift) | (2^var_shift −
    1), sweep, seed high word)``, word ``m % 4``.  ``var_shift`` is 8 for
    ``pt_heatbath.cu`` (K3) and 10 for ``pt_wide.cu`` (K5, whose problems
    are numbered g·B + b on the structured form)."""
    streams = np.arange(B)
    init01 = np.empty((B, M, R, n), np.float32)
    uniforms = np.empty((S, B, M, n, R), np.float32)
    swap_u = np.empty((S, B, M, R), np.float32)
    key = (np.uint64(seed & 0xFFFFFFFF), streams.astype(np.uint64)[:, None])
    r = np.arange(R, dtype=np.uint64)
    swap_tag = (1 << var_shift) - 1
    for m in range(M):
        y = m << var_shift
        init01[:, m] = _words(seed, streams, R, n, _INIT_SLOT, y) & np.uint64(1)
        for t in range(S):
            uniforms[t, :, m] = _uniform(_words(seed, streams, R, n, t, y)).transpose(0, 2, 1)
    for t in range(S):
        for mq in range(-(-M // 4)):
            out = philox4x32_10((r, np.uint64((mq << var_shift) | swap_tag), np.uint64(t),
                                 np.uint64(seed >> 32)), key)
            for w in range(min(4, M - 4 * mq)):
                swap_u[t, :, 4 * mq + w] = _uniform(np.broadcast_to(out[w], (B, R)))
    return (init01.reshape(B * M, R, n), uniforms.reshape(S, B * M, n, R),
            swap_u.reshape(S, B * M, R))


def _check_variates(host_variates, init_shape, u_shape):
    init01, uniforms = host_variates
    if tuple(init01.shape) != init_shape or tuple(uniforms.shape) != u_shape:
        raise ValueError(
            f"host_variates shapes {tuple(init01.shape)}, {tuple(uniforms.shape)}; "
            f"expected {init_shape}, {u_shape}")
    return init01, uniforms


def sa_sample_groups_plain(Q_shared: torch.Tensor, h_extra: torch.Tensor,
                           num_reads: int, num_sweeps: int, *,
                           generator: torch.Generator | None = None,
                           beta_hot=None, beta_cold=None,
                           host_variates=None) -> torch.Tensor:
    """Structured annealing: ``Q_shared`` (G, n, n) group QUBOs plus
    ``h_extra`` (G, B, n) per-problem linear terms → (G, B, R, n) samples
    in {0, 1}.  ``beta_hot``/``beta_cold`` (broadcastable to (G, B))
    override the default schedule endpoints."""
    G, n, _ = Q_shared.shape
    B = h_extra.shape[1]
    R, S = num_reads, num_sweeps
    dev = Q_shared.device
    hs, J = split_qubo(Q_shared.to(torch.float32))
    h = hs[:, None, :] + h_extra.to(torch.float32)  # (G, B, n)
    J = J[:, None]  # (G, 1, n, n): shared by the group's problems
    hot, logr = schedule_params(h, J, S, beta_hot, beta_cold)
    if host_variates is not None:
        init01, uniforms = _check_variates(host_variates, (G, B, R, n), (S, G, B, n, R))
        s = init01.to(dev, torch.float32).clone()
    else:
        s = (rand((G, B, R, n), generator, dev) < 0.5).to(torch.float32)
    span = inv_span(S)
    for t in range(S):
        u = uniforms[t].to(dev, torch.float32) if host_variates is not None \
            else rand((G, B, n, R), generator, dev)
        frac = float(np.float32(t) * np.float32(span))
        beta = hot * torch.exp(logr * frac)
        metropolis_sweep(s, -torch.log(u) / beta[..., None, None], h, J)
    return s


def sa_sample_batch_plain(Q: torch.Tensor, num_reads: int, num_sweeps: int, *,
                          generator: torch.Generator | None = None,
                          host_variates=None) -> torch.Tensor:
    """Dense annealing: ``Q`` (B, n, n) → (B, R, n), as G = B groups of one
    problem each (``h_extra = 0``)."""
    B, n = Q.shape[0], Q.shape[-1]
    hv = None
    if host_variates is not None:
        init01, uniforms = _check_variates(
            host_variates, (B, num_reads, n), (num_sweeps, B, n, num_reads))
        hv = (init01[:, None], uniforms[:, :, None])
    out = sa_sample_groups_plain(Q, Q.new_zeros((B, 1, n)), num_reads, num_sweeps,
                                 generator=generator, host_variates=hv)
    return out[:, 0]
