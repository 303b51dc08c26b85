"""Dense QUBO representation and energy math (counterpart of ``qbmx.core.qubo``).

Convention: a QUBO is a dense ``(n, n)`` float32 tensor ``Q`` whose diagonal
holds the linear terms and whose strictly-upper triangle holds the pairwise
terms; the energy of ``s ∈ {0,1}^n`` is

    E(s) = Σ_i Q_ii s_i + Σ_{i<j} (Q_ij + Q_ji) s_i s_j

Every function takes optional leading batch dimensions.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from qbmx_torch.utils.spans import span

LOG2 = math.log(2.0)
LOG100 = math.log(100.0)


def split_qubo(Q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Split a dense QUBO into ``(h, J)``: ``h`` (..., n) the diagonal and
    ``J`` (..., n, n) symmetric with zero diagonal, so that
    ``E(s) = h·s + ½ sᵀ J s`` and the flip delta of variable ``i`` is
    ``(1 - 2 s_i) (h_i + J_i · s)``."""
    h = torch.diagonal(Q, dim1=-2, dim2=-1)
    off = Q - torch.diag_embed(h)
    return h, off + off.transpose(-1, -2)


def densify_groups(Q_shared: torch.Tensor, h_extra: torch.Tensor) -> torch.Tensor:
    """(G, n, n) shared QUBOs + (G, B, n) per-problem linear terms → the
    (G*B, n, n) dense batch they represent."""
    n = Q_shared.shape[-1]
    diag = torch.diag_embed(h_extra.to(torch.float32))
    return (Q_shared[:, None] + diag).reshape(-1, n, n)


def qubo_energy(Q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Energy of one configuration ``s`` (n,) under ``Q`` (n, n)."""
    h, J = split_qubo(Q)
    return h @ s + 0.5 * (s @ (J @ s))


def qubo_energies(Q: torch.Tensor, S: torch.Tensor) -> torch.Tensor:
    """Energies of configurations ``S`` (m, n) under ``Q`` (n, n)."""
    h, J = split_qubo(Q)
    return S @ h + 0.5 * torch.einsum("mi,ij,mj->m", S, J, S)


def _over(c: float, x: torch.Tensor) -> torch.Tensor:
    # true division c / x (``float / Tensor`` in torch is reciprocal * c,
    # which rounds differently from the reference's division)
    return torch.full_like(x, c) / x


def beta_range_from_parts(h: torch.Tensor, J: torch.Tensor,
                          fallback: tuple[float, float] = (0.1, 10.0)):
    """Default (hot, cold) inverse temperatures of the QUBOs with linear
    terms ``h`` (..., n) and symmetric couplings ``J`` (broadcastable to
    (..., n, n)) — :func:`default_beta_range` without materializing the
    dense matrices.  The hot end gives the stiffest variable a ~50% flip
    chance (``ln 2 / max_i ΔE_i``), the cold end pins the smallest nonzero
    energy scale (``ln 100 / min(|h_i|, |J_ij|)``), with ``ΔE_i = |h_i| +
    Σ_j |J_ij|``; zero magnitudes are ignored and the schedule is kept
    monotone (``cold ≥ hot·1.0001``)."""
    absJ = J.abs()
    max_delta = (h.abs() + absJ.sum(-1)).amax(-1)
    with span("sync.beta_inf"):  # a host scalar copied to the device
        inf = torch.tensor(float("inf"), dtype=h.dtype, device=h.device)
    hmag = h.abs()
    h_min = torch.where(hmag > 0, hmag, inf).amin(-1)
    j_min = torch.where(absJ > 0, absJ, inf).flatten(-2).amin(-1)
    min_delta = torch.minimum(h_min, j_min)
    hot = torch.where(max_delta > 0, _over(LOG2, max_delta.clamp_min(1e-12)),
                      torch.full_like(max_delta, fallback[0]))
    cold = torch.where(torch.isfinite(min_delta),
                       _over(LOG100, min_delta.clamp_min(1e-12)),
                       torch.full_like(min_delta, fallback[1]))
    return hot, torch.maximum(cold, hot * 1.0001)


def default_beta_range(Q: torch.Tensor, fallback: tuple[float, float] = (0.1, 10.0)):
    """Heuristic (hot, cold) annealing range of dense QUBOs ``Q`` (..., n, n)
    (dwave-neal's default range; see :func:`beta_range_from_parts`)."""
    h, J = split_qubo(Q)
    return beta_range_from_parts(h, J, fallback)


def geometric_beta_schedule(beta_hot, beta_cold, num_sweeps: int) -> torch.Tensor:
    """(num_sweeps, ...) geometric interpolation from hot to cold."""
    beta_hot = torch.as_tensor(beta_hot, dtype=torch.float32)
    beta_cold = torch.as_tensor(beta_cold, dtype=torch.float32)
    if num_sweeps == 1:
        return beta_cold.reshape((1,) + tuple(beta_cold.shape))
    t = torch.arange(num_sweeps, dtype=torch.float32, device=beta_hot.device) / (num_sweeps - 1)
    t = t.reshape((num_sweeps,) + (1,) * beta_hot.dim())
    log_hot, log_cold = torch.log(beta_hot), torch.log(beta_cold)
    return torch.exp(log_hot + t * (log_cold - log_hot))


def random_qubo_batch(rng: np.random.Generator, batch: int, n: int,
                      scale: float = 1.0) -> torch.Tensor:
    """(batch, n, n) float32 random upper-triangular QUBOs with U(-scale,
    scale) entries, drawn from the numpy ``rng`` exactly as
    ``qbmx.core.qubo.random_qubo_batch`` draws them."""
    return torch.as_tensor(
        np.stack([np.triu(rng.uniform(-scale, scale, (n, n))) for _ in range(batch)]),
        dtype=torch.float32,
    )
