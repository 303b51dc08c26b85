"""Wrapper of the CUDA anneal kernel for wide QUBOs (``qbmx_torch/csrc/
anneal_wide.cu``, K4).

K4 computes what K1 (``sa_metropolis.cu``) and K2 (``sa_heatbath.cu``)
compute, on the same structured form (``J`` (G, n, n), ``h`` (G, B, n),
schedule ``hot``/``logr`` (G, B) → (G, B, R, n)), for the widths whose
couplings do not fit one block's shared memory.  ``sa_cuda`` and
``gibbs_cuda`` call :func:`launch` when ``kernel_call.fits_shared(n)`` is
false; its plain versions are theirs (``sa_torch``, ``gibbs``).  Its
launches are counted here, apart from K1's and K2's, so a run shows which
kernel served it.

In generator mode K4 draws the Philox streams of K1 and K2
(``sa_torch.philox_variates`` writes them out); ``host_variates``
``(init01 (G,B,R,n), uniforms (S,G,B,n,R))`` replace them.
"""

from __future__ import annotations

import ctypes

import torch

from qbmx_torch.core.rng import draw_seed
from qbmx_torch.samplers import kernel_call
from qbmx_torch.samplers.sa_torch import inv_span

#: the kernel's ``rule`` argument: Metropolis, or heat-bath at update width 1, 2, 4
METROPOLIS, HEATBATH, PAIR, QUAD = 0, 1, 2, 4

#: launches of K4 since the last reset (one per call that reached the GPU)
launch_counts = {"anneal_wide": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def launch(J: torch.Tensor, h: torch.Tensor, hot: torch.Tensor, logr: torch.Tensor,
           num_reads: int, num_sweeps: int, rule: int, *,
           generator: torch.Generator | None = None, host_variates=None) -> torch.Tensor:
    """Launch K4 on the structured form: ``J`` (G, n, n) symmetric
    zero-diagonal couplings, ``h`` (G, B, n) linear terms, ``hot``/``logr``
    (G, B) the schedule ``β_t = hot·exp(logr·t/(S−1))``, ``rule`` one of
    :data:`METROPOLIS`, :data:`HEATBATH`, :data:`PAIR`, :data:`QUAD` →
    (G, B, R, n) samples in {0, 1}.  Any width the kernel takes, so callers
    (and checks of the kernel itself) may send it narrow problems too."""
    from qbmx_torch._build import load_kernels

    if rule not in (METROPOLIS, HEATBATH, PAIR, QUAD):
        raise ValueError(f"anneal_wide kernel: unknown rule {rule}")
    lib = load_kernels()
    G, B, n = h.shape
    R, S = num_reads, num_sweeps
    ptrs = kernel_call.structured_ptrs("anneal_wide", lib.qbmx_anneal_wide_max_n(),
                                       J, h, hot, logr, R, S, host_variates)
    seed = draw_seed(generator) if host_variates is None else 0
    out = torch.empty((G, B, R, n), dtype=torch.float32, device=h.device)
    kernel_call.check_rc("anneal_wide", lib.qbmx_anneal_wide(
        *ptrs, out.data_ptr(), G, B, R, n, S, ctypes.c_float(inv_span(S)), seed, rule,
        kernel_call.stream(h.device)))
    launch_counts["anneal_wide"] += 1
    return out
