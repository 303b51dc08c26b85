"""Wrappers of the CUDA heat-bath kernel (``qbmx_torch/csrc/sa_heatbath.cu``).

``gibbs_sample_groups_cuda`` is the counterpart of
``qbmx.samplers.sa_lane.lane_sample_groups(rule="heatbath")`` and
``gibbs_sample_batch_cuda`` of ``qbmx.samplers.sa_pallas.
gibbs_sample_batch_pallas``; both launch the same kernel (a dense batch is
G = B groups of one problem), with the update width (single, pair, quad)
as asked: K2 while a group's couplings fit shared memory
(``kernel_call.fits_shared``), K4 (``wide_cuda``, ``anneal_wide.cu``)
above.  On CUDA tensors they launch a kernel or raise; on CPU tensors they
run the plain version (``gibbs``) — the tensor's device is the only thing
that decides.

K2 has K1's three layouts, a thread a chain (THREAD), a few lanes a chain
(GROUP: 4, 8 or 16; quad 16) or a warp a chain (LANES), chosen and named by
the rule the two share (``kernel_call.chain_layout``).

In generator mode the kernel draws the Philox streams of the Metropolis
kernel, keyed by a seed taken from ``generator`` and the problem's index;
``sa_torch.philox_variates`` writes them out.  ``host_variates`` (the JAX
kernels' ``debug_randoms`` shapes) make kernel and plain version consume
the same numbers.
"""

from __future__ import annotations

import ctypes

import torch

from qbmx_torch.core.qubo import split_qubo
from qbmx_torch.core.rng import draw_seed
from qbmx_torch.samplers import gibbs, kernel_call, wide_cuda
from qbmx_torch.samplers.sa_torch import _check_variates, inv_span

#: launches of the heat-bath kernel since the last reset (one per call that
#: reached the GPU)
launch_counts = {"sa_heatbath": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _width(pair: bool, quad: bool) -> int:
    return 4 if quad else 2 if pair else 1


#: sweeps between recomputations of the GROUP and LANES layouts' fields
#: (``sa_heatbath.cuh`` kRefreshPeriod), for ``wide_cuda.field_drift_bound``
REFRESH_PERIOD = 16


def launch(J, h, hot, logr, num_reads: int, num_sweeps: int, width: int, *, generator=None,
           host_variates=None, lanes: int | None = None, flips: torch.Tensor | None = None,
           fields_out: torch.Tensor | None = None) -> torch.Tensor:
    """Launch K2 on the structured form, ``J`` (G, n, n), ``h`` (G, B, n),
    ``hot``/``logr`` (G, B) → (G, B, R, n), update ``width`` 1, 2 or 4, in
    the layout ``kernel_call.chain_layout`` chooses (``lanes`` forces one: 1,
    4, 8, 16 or 32; quad 1, 16 or 32).  ``flips`` ((1,) int64) is added the
    number of variables changed; ``fields_out`` ((G, B, R, n) float32)
    receives the final fields of GROUP and LANES.  The sampler paths pass
    none of the three."""
    from qbmx_torch._build import load_kernels

    if width not in (1, 2, 4):
        raise ValueError(f"sa_heatbath kernel: unknown update width {width}")
    lib = load_kernels()
    G, B, n = h.shape
    R, S = num_reads, num_sweeps
    ptrs = kernel_call.structured_ptrs("sa_heatbath", lib.qbmx_sa_heatbath_max_n(),
                                       J, h, hot, logr, R, S, host_variates)
    layout = kernel_call.chain_layout(G, B, R, n, lanes, width)
    if fields_out is not None and layout.lanes == 1:
        raise ValueError("fields_out: the THREAD layout of sa_heatbath keeps no fields")
    seed = draw_seed(generator) if host_variates is None else 0
    out = torch.empty((G, B, R, n), dtype=torch.float32, device=h.device)
    fptr = kernel_call.optional_ptr(fields_out, "fields_out", (G, B, R, n), torch.float32,
                                    h.device)
    cptr = kernel_call.optional_ptr(flips, "flips", (1,), torch.int64, h.device)
    kernel_call.call("sa_heatbath", lib.qbmx_sa_heatbath,
        *ptrs, out.data_ptr(), fptr, cptr, G, B, R, n, S, ctypes.c_float(inv_span(S)), seed,
        width, layout.lanes, kernel_call.stream(h.device))
    launch_counts["sa_heatbath"] += 1
    return out


def _run(Q_shared, h_extra, num_reads, num_warmup, generator, beta, pair, quad,
         host_variates, dense_couplings: bool = False):
    """K2 on the structured form → (G, B, R, n); K4 where ``J_g`` does not
    fit shared memory (``dense_couplings``: ``wide_cuda.launch``'s)."""
    hs, J = split_qubo(Q_shared.to(torch.float32))
    J = J.contiguous()
    h = (hs[:, None, :] + h_extra.to(torch.float32)).contiguous()
    hot, logr = gibbs.heat_bath_schedule(h, J[:, None], num_warmup, beta)
    if kernel_call.fits_shared(h.shape[-1]):
        return launch(J, h, hot, logr, num_reads, num_warmup, _width(pair, quad),
                      generator=generator, host_variates=host_variates)
    return wide_cuda.launch(J, h, hot, logr, num_reads, num_warmup, _width(pair, quad),
                            generator=generator, host_variates=host_variates,
                            dense_couplings=dense_couplings)


def gibbs_sample_groups_cuda(Q_shared: torch.Tensor, h_extra: torch.Tensor,
                             num_reads: int, num_warmup: int, *,
                             generator: torch.Generator | None = None,
                             beta: float = 1.0, pair: bool = False, quad: bool = False,
                             host_variates=None, dense_couplings: bool = False) -> torch.Tensor:
    """Structured heat-bath, ``Q_shared`` (G, n, n) + ``h_extra`` (G, B, n)
    → (G, B, R, n), on the kernel for CUDA tensors; warm-up from
    ``min(default_hot, β)`` to ``β`` per problem."""
    if Q_shared.device.type != "cuda":
        return gibbs.gibbs_sample_groups_plain(
            Q_shared, h_extra, num_reads, num_warmup, generator=generator, beta=beta,
            pair=pair, quad=quad, host_variates=host_variates)
    return _run(Q_shared, h_extra, num_reads, num_warmup, generator, beta, pair, quad,
                host_variates, dense_couplings)


def gibbs_sample_batch_cuda(Q: torch.Tensor, num_reads: int, num_warmup: int, *,
                            generator: torch.Generator | None = None,
                            beta: float = 1.0, pair: bool = False, quad: bool = False,
                            host_variates=None) -> torch.Tensor:
    """Dense heat-bath, ``Q`` (B, n, n) → (B, R, n), as G = B groups of one
    problem each."""
    if Q.device.type != "cuda":
        return gibbs.gibbs_sample_batch_plain(
            Q, num_reads, num_warmup, generator=generator, beta=beta, pair=pair, quad=quad,
            host_variates=host_variates)
    B, n = Q.shape[0], Q.shape[-1]
    hv = None
    if host_variates is not None:
        init01, uniforms = _check_variates(
            host_variates, (B, num_reads, n), (num_warmup, B, n, num_reads))
        hv = (init01[:, None], uniforms[:, :, None])  # views: still contiguous
    out = _run(Q, Q.new_zeros((B, 1, n)), num_reads, num_warmup, generator, beta, pair,
               quad, hv)
    return out[:, 0]
