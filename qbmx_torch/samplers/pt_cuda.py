"""Wrapper of the CUDA parallel-tempering kernel
(``qbmx_torch/csrc/pt_heatbath.cu``).

``pt_sample_batch_cuda`` is the counterpart of ``qbmx.samplers.sa_pallas.
pt_sample_batch_pallas``.  On CUDA tensors it launches the kernel or
raises; on CPU tensors it runs the plain version (``tempering``) — the
tensor's device is the only thing that decides.

In generator mode the kernel draws Philox streams keyed by a seed taken
from ``generator`` and the ladder's problem index, with the rung in the
counter (``sa_torch.pt_philox_variates`` writes them out); ``host_variates``
``(init01 (B·M,R,n), uniforms (S,B·M,n,R), swap_u (S,B·M,R))`` make kernel
and plain version consume the same numbers.
"""

from __future__ import annotations

import torch

from qbmx_torch.core.qubo import split_qubo
from qbmx_torch.core.rng import draw_seed
from qbmx_torch.samplers import kernel_call, tempering

#: launches of the tempering kernel since the last reset (one per call that
#: reached the GPU)
launch_counts = {"pt_heatbath": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def pt_sample_batch_cuda(Q: torch.Tensor, num_reads: int, num_sweeps: int = 64, *,
                         num_replicas: int = 8, beta_target: float = 1.0,
                         generator: torch.Generator | None = None,
                         host_variates=None) -> torch.Tensor:
    """Batched parallel tempering, ``Q`` (B, n, n) → (B, R, n) samples of
    the target rung, on the kernel for CUDA tensors."""
    if Q.device.type != "cuda":
        return tempering.pt_sample_batch_plain(
            Q, num_reads, num_sweeps, num_replicas=num_replicas, beta_target=beta_target,
            generator=generator, host_variates=host_variates)
    from qbmx_torch._build import load_kernels

    B, n = Q.shape[0], Q.shape[-1]
    M, R, S = num_replicas, num_reads, num_sweeps
    dev = Q.device
    Q = Q.to(torch.float32)
    lib = load_kernels()
    max_n, max_m = lib.qbmx_pt_heatbath_max_n(), lib.qbmx_pt_heatbath_max_rungs()
    max_state = lib.qbmx_pt_heatbath_max_state()
    if n > max_n or M > max_m or M * n > max_state:
        raise ValueError(f"pt_heatbath kernel: n={n}, M={M} exceed its bound (n ≤ {max_n}, "
                         f"M ≤ {max_m}, M·n ≤ {max_state})")
    if B > 65535:
        raise ValueError(f"pt_heatbath kernel: {B} problems exceed the grid's 65535")
    variates = kernel_call.variate_ptrs(
        host_variates, (("init01", (B * M, R, n)), ("uniforms", (S, B * M, n, R)),
                        ("swap_u", (S, B * M, R))), dev)
    h, J = (t.contiguous() for t in split_qubo(Q))
    betas, dbeta = tempering.ladder_betas(Q, M, beta_target)
    seed = draw_seed(generator) if host_variates is None else 0
    out = torch.empty((B, R, n), dtype=torch.float32, device=dev)
    kernel_call.check_rc("pt_heatbath", lib.qbmx_pt_heatbath(
        J.data_ptr(), h.data_ptr(), betas.data_ptr(), dbeta.data_ptr(), *variates,
        out.data_ptr(), B, M, R, n, S, seed, kernel_call.stream(dev)))
    launch_counts["pt_heatbath"] += 1
    return out
