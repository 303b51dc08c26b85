"""Parallel tempering (replica exchange) in plain PyTorch — the plain version
of the CUDA kernel ``qbmx_torch/csrc/pt_heatbath.cu``.

Semantics of the TPU kernel's PT mode (``qbmx.samplers.sa_pallas.
pt_sample_batch_pallas``): every read of problem ``b`` is a ladder of M
rungs at fixed inverse temperatures on a geometric grid from
``min(default_hot, β_t/2)`` to the target ``β_t``.  Per sweep every rung
does one single-variable heat-bath sweep at its own β; then the links
``(m, m+1)`` with ``m % 2 == sweep % 2`` swap states iff
``dβ·dE < −log(u_swap)`` (``dβ = β[m+1] − β[m]``, ``dE = E[m] − E[m+1]``,
``u_swap`` the lower rung's slot).  The target rung M−1 is returned.

Energies are recomputed from the states after each sweep (the kernel
tracks them incrementally).  Any M ≥ 1 is taken: the TPU route's
power-of-two and pack-divisor rules on M are packing artifacts.  M = 1
returns the rung at ``β_hot``.

``host_variates = (init01 (B·M,R,n), uniforms (S,B·M,n,R), swap_u
(S,B·M,R))`` in slot ``b·M + m`` (``sa_pallas.py:814-816``).
"""

from __future__ import annotations

import torch

from qbmx_torch.core.qubo import default_beta_range, split_qubo
from qbmx_torch.core.rng import rand
from qbmx_torch.samplers.gibbs import heat_bath_sweep
from qbmx_torch.utils.spans import span


def ladder_betas(Q: torch.Tensor, num_replicas: int, beta_target: float = 1.0):
    """Per-ladder ``(betas, dbeta)`` (B, M) float32, as ``sa_pallas.py:820-826``
    computes them: ``dbeta[:, m] = betas[:, m+1] − betas[:, m]``, 0 on the
    last rung."""
    M = num_replicas
    hot0, _ = default_beta_range(Q.to(torch.float32))
    with span("sync.pt_betas"):  # a host scalar copied to the device
        bt = torch.tensor(beta_target, dtype=torch.float32, device=Q.device)
    beta_hot = torch.minimum(hot0, bt * 0.5)
    # tensor / tensor: true division (a scalar divisor may become a reciprocal)
    t = torch.arange(M, dtype=torch.float32, device=Q.device) / torch.full(
        (M,), float(max(M - 1, 1)), device=Q.device)
    log_hot = torch.log(beta_hot)[:, None]
    betas = torch.exp(log_hot + t[None, :] * (torch.log(bt) - log_hot))
    dbeta = torch.nn.functional.pad(betas[:, 1:] - betas[:, :-1], (0, 1))
    return betas.contiguous(), dbeta.contiguous()


def _check(host_variates, BM, R, n, S):
    shapes = ((BM, R, n), (S, BM, n, R), (S, BM, R))
    if len(host_variates) != 3 or any(tuple(a.shape) != w
                                      for a, w in zip(host_variates, shapes)):
        raise ValueError(f"host_variates shapes {[tuple(a.shape) for a in host_variates]}; "
                         f"expected {list(shapes)}")
    return host_variates


def pt_sample_batch_plain(Q: torch.Tensor, num_reads: int, num_sweeps: int = 64, *,
                          num_replicas: int = 8, beta_target: float = 1.0,
                          generator: torch.Generator | None = None,
                          host_variates=None) -> torch.Tensor:
    """Batched parallel tempering: ``Q`` (B, n, n) → (B, R, n) samples of
    the target rung."""
    B, n = Q.shape[0], Q.shape[-1]
    M, R, S = num_replicas, num_reads, num_sweeps
    dev = Q.device
    h, J = split_qubo(Q.to(torch.float32))
    h, J = h[:, None], J[:, None]  # (B, 1, n), (B, 1, n, n): shared by the rungs
    betas, dbeta = ladder_betas(Q, M, beta_target)
    if host_variates is not None:
        init01, uniforms, swap_u = _check(host_variates, B * M, R, n, S)
        s = init01.to(dev, torch.float32).reshape(B, M, R, n).clone()
    else:
        s = (rand((B, M, R, n), generator, dev) < 0.5).to(torch.float32)
    for t in range(S):
        if host_variates is not None:
            u = uniforms[t].to(dev, torch.float32).reshape(B, M, n, R)
            usw = swap_u[t].to(dev, torch.float32).reshape(B, M, R)
        else:
            u = rand((B, M, n, R), generator, dev)
            usw = rand((B, M, R), generator, dev)
        heat_bath_sweep(s, u, betas, h, J)
        if t % 2 >= M - 1:
            continue  # no link of this parity
        lo = torch.arange(t % 2, M - 1, 2, device=dev)  # this sweep's links
        E = (s @ h[..., None])[..., 0] + 0.5 * ((s @ J) * s).sum(-1)  # (B, M, R)
        dE = E[:, lo] - E[:, lo + 1]
        swap = (dbeta[:, lo, None] * dE < -torch.log(usw[:, lo]))[..., None]
        s_lo, s_hi = s[:, lo], s[:, lo + 1]
        s[:, lo] = torch.where(swap, s_hi, s_lo)
        s[:, lo + 1] = torch.where(swap, s_lo, s_hi)
    return s[:, M - 1]
