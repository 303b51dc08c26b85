"""Wrapper of the CUDA parallel-tempering kernel
(``qbmx_torch/csrc/pt_heatbath.cu``, K3).

``pt_sample_batch_cuda`` is the counterpart of ``qbmx.samplers.sa_pallas.
pt_sample_batch_pallas``.  On CUDA tensors it launches the kernel or
raises; on CPU tensors it runs the plain version (``tempering``) — the
tensor's device is the only thing that decides.

K3 has two layouts, a rung a thread or a rung a warp; :func:`pt_layout`
chooses between them from the launch's shape and states the kernel's
bounds.  Both swap temperatures, not states, between a ladder's rungs.

In generator mode the kernel draws Philox streams keyed by a seed taken
from ``generator`` and the ladder's problem index, with the rung in the
counter (``sa_torch.pt_philox_variates`` writes them out); ``host_variates``
``(init01 (B·M,R,n), uniforms (S,B·M,n,R), swap_u (S,B·M,R))`` make kernel
and plain version consume the same numbers.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from qbmx_torch.core.qubo import split_qubo
from qbmx_torch.core.rng import draw_seed
from qbmx_torch.samplers import kernel_call, tempering

#: launches of the tempering kernel since the last reset (one per call that
#: reached the GPU)
launch_counts = {"pt_heatbath": 0}

#: the kernel's ``layout`` argument: a rung a thread, a rung a warp
RUNG, WARP = 0, 1
MAX_N = 241  # J_b in one block's shared memory (qbmx_pt_heatbath_max_n)
MAX_RUNGS = 64  # the WARP layout: 32 warps of 2 rungs (qbmx_pt_heatbath_max_rungs)
RUNG_MAX_N, RUNG_MAX_M = 8, 32  # the RUNG layout: n unrolled, a ladder within a warp
RUNG_THREADS = 128  # threads a block of the RUNG layout (pt_heatbath.cu kThreads)
BOUNDS = (f"n ≤ {MAX_N}, M ≤ {MAX_RUNGS}, and J_b with the 2·M exchanged energies, "
          f"4·(n² + 2·M) bytes, within {kernel_call.SMEM_BYTES:,}: M ≤ 15 at n = 241")


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


@dataclasses.dataclass(frozen=True)
class PTLayout:
    kind: int  # RUNG or WARP
    threads: int  # per block
    ladders_per_block: int
    rungs_per_warp: int  # rungs a warp carries in turn (RUNG: a rung a lane)
    smem: int  # bytes per block
    grid: tuple  # (blocks per problem, problems)


def smem_bytes(kind: int, n: int, M: int) -> int:
    """A block's shared memory: J_b, and in the WARP layout the energies by
    rung of two sweeps (``qbmx_pt_heatbath_smem``)."""
    return 4 * (n * n + (2 * M if kind == WARP else 0))


def pt_layout(B: int, M: int, R: int, n: int, kind: int | None = None) -> PTLayout:
    """K3's layout for B problems, M rungs, R reads (ladders a problem),
    width n.

    Rule: a rung a thread (RUNG) at n ≤ 8 and M ≤ 32: a ladder's rungs on
    M adjacent lanes of a warp, ⌊32/M⌋ ladders a warp, 4 warps a block of
    one problem, the state in registers; otherwise a rung a warp (WARP): a
    ladder a block of ⌈M / RPW⌉ warps, each carrying RPW = 1 (M ≤ 32) or 2
    rungs in turn, J_b and the exchanged energies in shared memory.
    ``kind`` overrides the choice (for checks of a layout; the sampler path
    never passes it).  Raises on what the kernel does not take (see
    :data:`BOUNDS`): M·n is not bounded."""
    # the WARP layout takes every shape the kernel does (the RUNG layout's
    # J_b alone always fits)
    if not (1 <= n <= MAX_N and 1 <= M <= MAX_RUNGS) \
            or smem_bytes(WARP, n, M) > kernel_call.SMEM_BYTES:
        raise ValueError(f"pt_heatbath kernel: n={n}, M={M} exceed its bound ({BOUNDS})")
    if B > 65535:
        raise ValueError(f"pt_heatbath kernel: {B} problems exceed the grid's 65535")
    if kind is None:
        kind = RUNG if n <= RUNG_MAX_N and M <= RUNG_MAX_M else WARP
    if kind == RUNG:
        if n > RUNG_MAX_N or M > RUNG_MAX_M:
            raise ValueError(f"pt_heatbath kernel: no RUNG layout at n={n}, M={M} "
                             f"(n ≤ {RUNG_MAX_N}, M ≤ {RUNG_MAX_M})")
        per_block = RUNG_THREADS // 32 * (32 // M)
        return PTLayout(RUNG, RUNG_THREADS, per_block, 1, smem_bytes(RUNG, n, M),
                        (math.ceil(R / per_block), B))
    if kind != WARP:
        raise ValueError(f"pt_heatbath kernel: unknown layout {kind}")
    rpw = 1 if M <= 32 else 2
    return PTLayout(WARP, 32 * math.ceil(M / rpw), 1, rpw, smem_bytes(WARP, n, M), (R, B))


def pt_sample_batch_cuda(Q: torch.Tensor, num_reads: int, num_sweeps: int = 64, *,
                         num_replicas: int = 8, beta_target: float = 1.0,
                         generator: torch.Generator | None = None,
                         host_variates=None, _layout: int | None = None) -> torch.Tensor:
    """Batched parallel tempering, ``Q`` (B, n, n) → (B, R, n) samples of
    the target rung, on the kernel for CUDA tensors.  ``_layout`` forces a
    layout of :func:`pt_layout` (for checks of a layout)."""
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
    layout = pt_layout(B, M, R, n, _layout)
    variates = kernel_call.variate_ptrs(
        host_variates, (("init01", (B * M, R, n)), ("uniforms", (S, B * M, n, R)),
                        ("swap_u", (S, B * M, R))), dev)
    h, J = (t.contiguous() for t in split_qubo(Q))
    betas, dbeta = tempering.ladder_betas(Q, M, beta_target)
    seed = draw_seed(generator) if host_variates is None else 0
    out = torch.empty((B, R, n), dtype=torch.float32, device=dev)
    kernel_call.check_rc("pt_heatbath", lib.qbmx_pt_heatbath(
        J.data_ptr(), h.data_ptr(), betas.data_ptr(), dbeta.data_ptr(), *variates,
        out.data_ptr(), B, M, R, n, S, seed, layout.kind, kernel_call.stream(dev)))
    launch_counts["pt_heatbath"] += 1
    return out
