"""Wrappers of the CUDA Metropolis kernel (``qbmx_torch/csrc/sa_metropolis.cu``).

``sa_sample_groups_cuda`` is the counterpart of
``qbmx.samplers.sa_lane.lane_sample_groups`` and ``sa_sample_batch_cuda``
of ``qbmx.samplers.sa_pallas.sa_sample_batch_pallas``; both launch the same
kernel (a dense batch is G = B groups of one problem): K1 while a group's
couplings fit shared memory (``kernel_call.fits_shared``), K4
(``wide_cuda``, ``anneal_wide.cu``) above.  On CUDA tensors they launch a
kernel or raise; on CPU tensors they run the plain version (``sa_torch``)
— the tensor's device is the only thing that decides.

K1 has three layouts: a thread a chain (THREAD), a few lanes a chain
(GROUP: 4, 8 or 16) or a warp a chain (LANES); ``kernel_call.chain_layout``,
the rule K2 shares, chooses among them from the launch's shape and names
the route (``ChainLayout.route``).

In generator mode the kernel draws its own Philox streams, keyed by a seed
taken from ``generator`` and the problem's index, so its samples are not
the plain version's draws; ``host_variates`` (the JAX kernels'
``debug_randoms`` shapes) make both consume the same numbers.
"""

from __future__ import annotations

import ctypes

import torch

from qbmx_torch.core.qubo import split_qubo
from qbmx_torch.core.rng import draw_seed
from qbmx_torch.samplers import kernel_call, wide_cuda
from qbmx_torch.samplers.sa_torch import (
    _check_variates,
    inv_span,
    sa_sample_batch_plain,
    sa_sample_groups_plain,
    schedule_params,
)

#: launches of the Metropolis kernel since the last reset (one per call
#: that reached the GPU)
launch_counts = {"sa_metropolis": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def launch(J, h, hot, logr, num_reads: int, num_sweeps: int, *, generator=None,
           host_variates=None, lanes: int | None = None,
           flips: torch.Tensor | None = None,
           fields_out: torch.Tensor | None = None) -> torch.Tensor:
    """Launch K1 on the structured form, ``J`` (G, n, n), ``h`` (G, B, n),
    ``hot``/``logr`` (G, B) → (G, B, R, n), in the layout
    ``kernel_call.chain_layout`` chooses (``lanes`` forces one: 1, 4, 8, 16
    or 32).  ``flips`` ((1,) int64) is added the number of flips the launch
    made; ``fields_out`` ((G, B, R, n) float32) receives the final fields of
    GROUP and LANES.  The sampler paths pass none of the three."""
    from qbmx_torch._build import load_kernels

    lib = load_kernels()
    G, B, n = h.shape
    R, S = num_reads, num_sweeps
    ptrs = kernel_call.structured_ptrs("sa_metropolis", lib.qbmx_sa_metropolis_max_n(),
                                       J, h, hot, logr, R, S, host_variates)
    layout = kernel_call.chain_layout(G, B, R, n, lanes, kernel_call.METROPOLIS)
    if fields_out is not None and layout.lanes == 1:
        raise ValueError("fields_out: the THREAD layout of sa_metropolis keeps no fields")
    seed = draw_seed(generator) if host_variates is None else 0
    out = torch.empty((G, B, R, n), dtype=torch.float32, device=h.device)
    fptr = kernel_call.optional_ptr(fields_out, "fields_out", (G, B, R, n), torch.float32,
                                    h.device)
    cptr = kernel_call.optional_ptr(flips, "flips", (1,), torch.int64, h.device)
    kernel_call.call("sa_metropolis", lib.qbmx_sa_metropolis,
        *ptrs, out.data_ptr(), fptr, cptr, G, B, R, n, S, ctypes.c_float(inv_span(S)), seed,
        layout.lanes, kernel_call.stream(h.device))
    launch_counts["sa_metropolis"] += 1
    return out


def _launch(J, h, hot, logr, num_reads: int, num_sweeps: int, generator,
            host_variates, dense_couplings: bool = False) -> torch.Tensor:
    """K1 on the structured form; K4 where ``J_g`` does not fit shared
    memory (``dense_couplings``: :func:`wide_cuda.launch`'s)."""
    if not kernel_call.fits_shared(h.shape[-1]):
        return wide_cuda.launch(J, h, hot, logr, num_reads, num_sweeps, wide_cuda.METROPOLIS,
                                generator=generator, host_variates=host_variates,
                                dense_couplings=dense_couplings)
    return launch(J, h, hot, logr, num_reads, num_sweeps, generator=generator,
                  host_variates=host_variates)


def sa_sample_groups_cuda(Q_shared: torch.Tensor, h_extra: torch.Tensor,
                          num_reads: int, num_sweeps: int, *,
                          generator: torch.Generator | None = None,
                          beta_hot=None, beta_cold=None,
                          host_variates=None, dense_couplings: bool = False) -> torch.Tensor:
    """Structured annealing, ``Q_shared`` (G, n, n) + ``h_extra`` (G, B, n)
    → (G, B, R, n), on the kernel for CUDA tensors.  Schedule endpoints
    default per problem exactly as ``sa_lane.py:463-488`` computes them.
    ``dense_couplings``: the caller knows J_g dense (``wide_cuda.launch``)."""
    if Q_shared.device.type != "cuda":
        return sa_sample_groups_plain(
            Q_shared, h_extra, num_reads, num_sweeps, generator=generator,
            beta_hot=beta_hot, beta_cold=beta_cold, host_variates=host_variates)
    hs, J = split_qubo(Q_shared.to(torch.float32))
    h = (hs[:, None, :] + h_extra.to(torch.float32)).contiguous()
    hot, logr = schedule_params(h, J[:, None], num_sweeps, beta_hot, beta_cold)
    return _launch(J.contiguous(), h, hot, logr, num_reads, num_sweeps, generator,
                   host_variates, dense_couplings)


def sa_sample_batch_cuda(Q: torch.Tensor, num_reads: int, num_sweeps: int, *,
                         generator: torch.Generator | None = None,
                         host_variates=None) -> torch.Tensor:
    """Dense annealing, ``Q`` (B, n, n) → (B, R, n), as G = B groups of one
    problem each; schedule endpoints as ``sa_pallas.py:739-742``."""
    if Q.device.type != "cuda":
        return sa_sample_batch_plain(Q, num_reads, num_sweeps, generator=generator,
                                     host_variates=host_variates)
    B, n = Q.shape[0], Q.shape[-1]
    hv = None
    if host_variates is not None:
        init01, uniforms = _check_variates(
            host_variates, (B, num_reads, n), (num_sweeps, B, n, num_reads))
        hv = (init01[:, None], uniforms[:, :, None])  # views: still contiguous
    h, J = split_qubo(Q.to(torch.float32))
    h = h[:, None, :].contiguous()  # (B, 1, n)
    hot, logr = schedule_params(h, J[:, None], num_sweeps)
    out = _launch(J.contiguous(), h, hot, logr, num_reads, num_sweeps, generator, hv)
    return out[:, 0]
