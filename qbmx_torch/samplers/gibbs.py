"""Annealed heat-bath ("BMS") sweeps in plain PyTorch — the plain version of
the CUDA kernel ``qbmx_torch/csrc/sa_heatbath.cu``.

Counterpart of ``qbmx.samplers.gibbs`` and of the two TPU kernels'
heat-bath mode (``sa_lane._lane_kernel`` with ``rule="heatbath"`` over the
structured form, ``sa_pallas._sa_kernel`` through
``gibbs_sample_batch_pallas`` over a dense batch).  Each read is its own
chain, warmed up over ``num_warmup`` sweeps on the kernels' schedule
``β_t = hot·exp(logr·t/(S−1))`` from ``hot = min(default_hot, β)`` to the
target ``β`` (a single sweep runs at ``β``), then read out once.

Three update widths, each a sequential-scan Gibbs sweep that preserves the
Boltzmann distribution:

* single: variable ``i`` becomes 1 iff ``field < (log(1−u) − log(u))/β``;
* pair: variables ``(2q, 2q+1)`` are drawn jointly from their exact
  4-state conditional with ``u[2q]``; a trailing odd variable is 1 iff
  ``u·(1 + exp(β·field)) < 1``;
* quad: variables ``4q..4q+3`` are drawn from their exact 16-state
  conditional with ``u[4q]``, then a remainder pair and/or a trailing
  single as above.

The float operations copy ``qbmx.samplers.gibbs`` in the same association
order, so under the same variates the two packages give the same states.
Shapes: ``s`` (..., R, n) states in {0,1}, updated IN PLACE; ``u`` (..., n,
R) uniforms; ``beta`` broadcastable to ``s.shape[:-2]``; ``h`` (..., n);
``J`` (..., n, n) symmetric with zero diagonal.

``host_variates`` take the JAX kernels' ``debug_randoms`` shapes:
structured ``(init01 (G,B,R,n), uniforms (S,G,B,n,R))``, dense
``(init01 (B,R,n), uniforms (S,B,n,R))``.
"""

from __future__ import annotations

import numpy as np
import torch

from qbmx_torch.core.qubo import beta_range_from_parts, split_qubo
from qbmx_torch.core.rng import rand
from qbmx_torch.samplers.sa_torch import _check_variates, inv_span, schedule_params

# quad state index s = b1·8 + b2·4 + b3·2 + b4 (MSB = lowest variable); the
# six intra-quad coupling pairs in lexicographic order
_QUAD_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def _field(s, h, J, i):
    return h[..., i, None] + torch.matmul(s, J[..., i, :, None])[..., 0]  # (..., R)


def _set(s, i, v):
    s[..., i] = v.to(s.dtype)


def heat_bath_sweep(s, u, beta, h, J):
    """One single-variable heat-bath sweep over variables 0..n−1."""
    beta = torch.as_tensor(beta, dtype=s.dtype, device=s.device)
    thresh = (torch.log(1 - u) - torch.log(u)) / beta[..., None, None]  # (..., n, R)
    for i in range(s.shape[-1]):
        _set(s, i, _field(s, h, J, i) < thresh[..., i, :])
    return s


def _pair_update(s, u, beta, h, J, i):
    """Variables (i, i+1) from their exact 4-state conditional, with u[i]."""
    f1 = _field(s, h, J, i)
    f2 = _field(s, h, J, i + 1)
    c = J[..., i, i + 1, None]
    f1p = f1 - c * s[..., i + 1]  # fields excluding the partner
    f2p = f2 - c * s[..., i]
    e01 = -beta * f2p
    e10 = -beta * f1p
    e11 = -beta * (f1p + f2p + c)
    m = torch.maximum(torch.maximum(e01, e10), torch.clamp_min(e11, 0.0))
    w00 = torch.exp(-m)
    w01 = torch.exp(e01 - m)
    w10 = torch.exp(e10 - m)
    w11 = torch.exp(e11 - m)
    Z = w00 + w01 + w10 + w11
    t = u[..., i, :] * Z
    cum2 = w00 + w01
    cum3 = cum2 + w10
    _set(s, i, t >= cum2)
    _set(s, i + 1, ((t >= w00) & (t < cum2)) | (t >= cum3))


def _single_update(s, u, beta, h, J, i):
    """Variable i alone: u < σ(−βf) ⟺ u·(1 + exp(βf)) < 1 (inf-safe:
    an overflow keeps it 0)."""
    w = torch.exp(beta * _field(s, h, J, i))
    _set(s, i, u[..., i, :] * (1.0 + w) < 1.0)


# (16, 4) bit of variable a in joint state idx, and (16, 6) whether the
# state holds both variables of each coupling pair
_QUAD_BITS = torch.tensor([[(idx >> (3 - a)) & 1 for a in range(4)] for idx in range(16)],
                          dtype=torch.bool)
_QUAD_PAIR_BITS = torch.stack([_QUAD_BITS[:, a] & _QUAD_BITS[:, b] for a, b in _QUAD_PAIRS], 1)


def _quad_update(s, u, beta, h, J, i):
    """Variables i..i+3 from their exact 16-state conditional, with u[i].

    The 16 state energies are formed at once over a state axis, adding each
    term in qbmx's order and 0 where a state lacks it: ``x + 0 == x``
    exactly, so every energy equals the sequential one up to the sign of a
    zero, which no later step can see.  The running sums that pick the
    state stay sequential."""
    f = [_field(s, h, J, i + a) for a in range(4)]  # (..., R) each
    c = {(a, b): J[..., i + a, i + b, None] for a, b in _QUAD_PAIRS}  # (..., 1)
    fp = []
    for a in range(4):
        fa = f[a]
        for b in range(4):
            if b != a:
                fa = fa - c[(min(a, b), max(a, b))] * s[..., i + b]
        fp.append(fa)
    bits, pair_bits = _QUAD_BITS.to(s.device), _QUAD_PAIR_BITS.to(s.device)
    acc = torch.zeros(fp[0].shape[:-1] + (16,) + fp[0].shape[-1:], dtype=s.dtype,
                      device=s.device)  # (..., 16, R)
    for a in range(4):
        acc = acc + torch.where(bits[:, a, None], fp[a][..., None, :], 0.0)
    for k, ab in enumerate(_QUAD_PAIRS):
        acc = acc + torch.where(pair_bits[:, k, None], c[ab][..., None, :], 0.0)
    es = -beta[..., None, :] * acc
    m = torch.clamp_min(es[..., 1:, :].amax(-2, keepdim=True), 0.0)
    ws = torch.exp(es - m)
    cum = ws[..., 0, :]
    cums = [cum]
    for idx in range(1, 16):
        cum = cum + ws[..., idx, :]
        cums.append(cum)
    t = u[..., i, :] * cums[15]
    sel = (t[..., None, :] >= torch.stack(cums[:15], -2)).sum(-2)
    for a in range(4):
        _set(s, i + a, (sel >> (3 - a)) & 1)


def pair_heat_bath_sweep(s, u, beta, h, J):
    """One pair sweep: pairs (0,1), (2,3), …, then a trailing single."""
    beta = torch.as_tensor(beta, dtype=s.dtype, device=s.device)[..., None]
    n = s.shape[-1]
    for q in range(n // 2):
        _pair_update(s, u, beta, h, J, 2 * q)
    if n % 2:
        _single_update(s, u, beta, h, J, n - 1)
    return s


def quad_heat_bath_sweep(s, u, beta, h, J):
    """One quad sweep: quads (0..3), (4..7), …, then a remainder pair
    and/or a trailing single."""
    beta = torch.as_tensor(beta, dtype=s.dtype, device=s.device)[..., None]
    n = s.shape[-1]
    nq = n // 4
    for q in range(nq):
        _quad_update(s, u, beta, h, J, 4 * q)
    r = n - 4 * nq
    if r >= 2:
        _pair_update(s, u, beta, h, J, 4 * nq)
    if r % 2:
        _single_update(s, u, beta, h, J, n - 1)
    return s


def sweep_fn(pair: bool = False, quad: bool = False):
    """The sweep of the given update width (quad wins over pair)."""
    return quad_heat_bath_sweep if quad else pair_heat_bath_sweep if pair else heat_bath_sweep


def heat_bath_schedule(h: torch.Tensor, J: torch.Tensor, num_warmup: int, beta):
    """Per-problem ``(hot, logr)`` (G, B) of the warm-up ramp from
    ``min(default_hot, β)`` to ``β`` (``sa_lane.py:479-481``,
    ``sa_pallas.py:779-784``); a single sweep runs at ``β``."""
    d_hot, _ = beta_range_from_parts(h, J)
    beta = torch.as_tensor(beta, dtype=torch.float32, device=h.device).expand(d_hot.shape)
    return schedule_params(h, J, num_warmup, torch.minimum(d_hot, beta), beta)


def gibbs_sample_groups_plain(Q_shared: torch.Tensor, h_extra: torch.Tensor,
                              num_reads: int, num_warmup: int, *,
                              generator: torch.Generator | None = None,
                              beta: float = 1.0, pair: bool = False, quad: bool = False,
                              host_variates=None) -> torch.Tensor:
    """Structured heat-bath: ``Q_shared`` (G, n, n) group QUBOs plus
    ``h_extra`` (G, B, n) per-problem linear terms → (G, B, R, n) samples
    in {0, 1} at inverse temperature ``beta``."""
    G, n, _ = Q_shared.shape
    B = h_extra.shape[1]
    R, S = num_reads, num_warmup
    dev = Q_shared.device
    hs, J = split_qubo(Q_shared.to(torch.float32))
    h = hs[:, None, :] + h_extra.to(torch.float32)  # (G, B, n)
    J = J[:, None]  # (G, 1, n, n): shared by the group's problems
    hot, logr = heat_bath_schedule(h, J, S, beta)
    if host_variates is not None:
        init01, uniforms = _check_variates(host_variates, (G, B, R, n), (S, G, B, n, R))
        s = init01.to(dev, torch.float32).clone()
    else:
        s = (rand((G, B, R, n), generator, dev) < 0.5).to(torch.float32)
    sweep = sweep_fn(pair, quad)
    span = inv_span(S)
    for t in range(S):
        u = uniforms[t].to(dev, torch.float32) if host_variates is not None \
            else rand((G, B, n, R), generator, dev)
        frac = float(np.float32(t) * np.float32(span))
        sweep(s, u, hot * torch.exp(logr * frac), h, J)
    return s


def gibbs_sample_batch_plain(Q: torch.Tensor, num_reads: int, num_warmup: int, *,
                             generator: torch.Generator | None = None,
                             beta: float = 1.0, pair: bool = False, quad: bool = False,
                             host_variates=None) -> torch.Tensor:
    """Dense heat-bath: ``Q`` (B, n, n) → (B, R, n), as G = B groups of one
    problem each (``h_extra = 0``)."""
    B, n = Q.shape[0], Q.shape[-1]
    hv = None
    if host_variates is not None:
        init01, uniforms = _check_variates(
            host_variates, (B, num_reads, n), (num_warmup, B, n, num_reads))
        hv = (init01[:, None], uniforms[:, :, None])
    out = gibbs_sample_groups_plain(Q, Q.new_zeros((B, 1, n)), num_reads, num_warmup,
                                    generator=generator, beta=beta, pair=pair, quad=quad,
                                    host_variates=hv)
    return out[:, 0]
