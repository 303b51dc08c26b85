"""Wrapper of the CUDA parallel-tempering kernel
(``qbmx_torch/csrc/pt_heatbath.cu`` over ``pt_heatbath.cuh``, K3).

``pt_sample_batch_cuda`` is the counterpart of ``qbmx.samplers.sa_pallas.
pt_sample_batch_pallas``.  On CUDA tensors it launches the kernel or
raises; on CPU tensors it runs the plain version (``tempering``) — the
tensor's device is the only thing that decides.

K3 has three layouts, named by the lanes a rung: a rung a thread (RUNG,
1), a rung on 4, 8 or 16 lanes (GROUP) and a rung a warp (WARP, 32);
:func:`pt_layout` chooses among them from the launch's shape, by
boundaries the card measured (``cli/compare_kernels.py --parts
pt_layouts``), and states the kernel's bounds.  Every layout swaps
temperatures, not states, between a ladder's rungs; GROUP gives WARP's
samples bit for bit.

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

#: the kernel's ``lanes`` argument: a rung a thread, a rung a warp; GROUP
#: takes the lanes of ``GROUP_LANES``
RUNG, WARP = 1, 32
GROUP_LANES = (4, 8, 16)
LAYOUTS = (RUNG, *GROUP_LANES, WARP)
MAX_N = 241  # J_b in one block's shared memory (qbmx_pt_heatbath_max_n)
MAX_RUNGS = 64  # the WARP layout: 32 warps of 2 rungs (qbmx_pt_heatbath_max_rungs)
RUNG_MAX_N, RUNG_MAX_M = 32, 32  # the RUNG layout: n unrolled, a ladder within a warp
MAX_SLOTS = 8  # variables a lane of GROUP and WARP owns (pt_heatbath.cuh kMaxSlots)
THREADS = 128  # threads a block of RUNG, and of GROUP with its ladders in a warp
BOUNDS = (f"n ≤ {MAX_N}, M ≤ {MAX_RUNGS}, and J_b with the 2·M exchanged energies, "
          f"4·(n² + 2·M) bytes, within {kernel_call.SMEM_BYTES:,}: M ≤ 15 at n = 241")
# The rule's boundaries, from the card (``cli/compare_kernels.py --parts
# pt_layouts``, PERF.md §5): a rung a thread at every n ≤ 8, and up to
# RUNG_MAX_N from this many rungs a variable on, at most RUNG_MIN_RUNGS
# (K1's and K2's boundaries; from 48,000 rungs it led at every n ≤ 32) ...
RUNG_RUNGS_A_VARIABLE = 1_500
RUNG_MIN_RUNGS = 16_000
# ... else GROUP's fewest lanes a rung whose slots hold n: up to
# MAX_SLOTS where the rungs put FILL_LANES lanes on the card (about 11
# warps a SM), else up to FEW_SLOTS, a rung spread wider on an idle card
# (the CDQBM (b) PT call, 4,800 rungs at n = 41: 16 lanes 1.14x faster
# than 8); none: a rung a warp
FILL_LANES = 48_000
FEW_SLOTS = 4


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def max_n(lanes: int) -> int:
    """The widest n K3 takes at ``lanes`` lanes a rung (0: no such layout)."""
    if lanes == RUNG:
        return RUNG_MAX_N
    if lanes in GROUP_LANES:
        return lanes * MAX_SLOTS
    return MAX_N if lanes == WARP else 0


@dataclasses.dataclass(frozen=True)
class PTLayout:
    lanes: int  # a rung's lanes: 1 (RUNG), 4, 8, 16 (GROUP) or 32 (WARP)
    threads: int  # per block
    ladders_per_block: int
    rungs_per_warp: int  # rungs a warp carries in turn (WARP: 1 or 2; else 1)
    smem: int  # bytes per block
    grid: tuple  # (blocks per problem, problems)

    @property
    def route(self) -> str:
        """The layout's name in the records: "a rung a thread", "L lanes a
        rung" or "a rung a warp"."""
        if self.lanes == RUNG:
            return "a rung a thread"
        return "a rung a warp" if self.lanes == WARP else f"{self.lanes} lanes a rung"


def smem_bytes(lanes: int, n: int, M: int) -> int:
    """A block's shared memory at ``lanes`` lanes a rung: J_b (RUNG: its rows
    padded to 4 floats past n = 8), and where a ladder spans warps the
    energies by rung of two sweeps (``qbmx_pt_heatbath_smem``)."""
    if lanes == RUNG:
        return 4 * n * (n if n <= 8 else (n + 3) // 4 * 4)
    return 4 * (n * n + (2 * M if M * lanes > 32 else 0))


def pt_layout(B: int, M: int, R: int, n: int, lanes: int | None = None) -> PTLayout:
    """K3's layout for B problems, M rungs, R reads (ladders a problem),
    width n.

    Rule: a rung a thread (RUNG) at n ≤ 8, and up to n = ``RUNG_MAX_N`` when
    the rungs are many, B·M·R ≥ min(``RUNG_MIN_RUNGS``,
    ``RUNG_RUNGS_A_VARIABLE``·n) (M ≤ 32): a ladder's rungs on M adjacent
    lanes of a warp, ⌊32/M⌋ ladders a warp, 4 warps a block of one problem,
    the state in registers and a field a dot product.  Otherwise a rung on
    L lanes, the fields incremental: the fewest L of 4, 8, 16 (GROUP) whose
    slots hold n, up to ``MAX_SLOTS`` a lane where the rungs put
    ``FILL_LANES`` lanes on the card and up to ``FEW_SLOTS`` where they do
    not, else 32 (WARP: a ladder a block of ⌈M / RPW⌉ warps, each carrying
    RPW = 1 (M ≤ 32) or 2 rungs in turn).
    A GROUP ladder of M·L ≤ 32 lanes lies in one warp (⌊32/(M·L)⌋ ladders
    a warp, 4 warps a block), a longer one is a block of ⌈M·L/32⌉ warps;
    WARP and such ladders keep the exchanged energies in shared memory
    beside J_b.  ``lanes`` overrides the choice (for checks and timings of
    a layout; the sampler path never passes it) and raises where that
    layout cannot take the shape.  Raises on what the kernel does not take
    (see :data:`BOUNDS`): M·n is not bounded."""
    # the WARP layout takes every shape the kernel does (the other layouts'
    # blocks hold no more)
    if not (1 <= n <= MAX_N and 1 <= M <= MAX_RUNGS) \
            or smem_bytes(WARP, n, M) > kernel_call.SMEM_BYTES:
        raise ValueError(f"pt_heatbath kernel: n={n}, M={M} exceed its bound ({BOUNDS})")
    if B > 65535:
        raise ValueError(f"pt_heatbath kernel: {B} problems exceed the grid's 65535")
    rungs = B * M * R
    if lanes is None:
        many = rungs >= min(RUNG_MIN_RUNGS, RUNG_RUNGS_A_VARIABLE * n)
        if M <= RUNG_MAX_M and (n <= 8 or n <= RUNG_MAX_N and many):
            lanes = RUNG
        else:
            lanes = next((L for L in GROUP_LANES
                          if n <= L * (MAX_SLOTS if rungs * L >= FILL_LANES else FEW_SLOTS)),
                         WARP)
    if lanes not in LAYOUTS:
        raise ValueError(f"pt_heatbath kernel: unknown layout of {lanes} lanes a rung")
    if n > max_n(lanes) or (lanes == RUNG and M > RUNG_MAX_M):
        raise ValueError(f"pt_heatbath kernel: no layout of {lanes} lanes a rung at n={n}, "
                         f"M={M} (n ≤ {max_n(lanes)}"
                         + (f", M ≤ {RUNG_MAX_M})" if lanes == RUNG else ")"))
    smem = smem_bytes(lanes, n, M)
    if lanes == RUNG or M * lanes <= 32:
        per_block = THREADS // 32 * (32 // (M * lanes))
        return PTLayout(lanes, THREADS, per_block, 1, smem, (math.ceil(R / per_block), B))
    if lanes == WARP:
        rpw = 1 if M <= 32 else 2
        return PTLayout(WARP, 32 * math.ceil(M / rpw), 1, rpw, smem, (R, B))
    return PTLayout(lanes, 32 * math.ceil(M * lanes / 32), 1, 1, smem, (R, B))


def pt_sample_batch_cuda(Q: torch.Tensor, num_reads: int, num_sweeps: int = 64, *,
                         num_replicas: int = 8, beta_target: float = 1.0,
                         generator: torch.Generator | None = None,
                         host_variates=None, _layout: int | None = None) -> torch.Tensor:
    """Batched parallel tempering, ``Q`` (B, n, n) → (B, R, n) samples of
    the target rung, on the kernel for CUDA tensors.  ``_layout`` forces a
    layout of :func:`pt_layout` by its lanes a rung (for checks of a
    layout)."""
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
    kernel_call.call("pt_heatbath", lib.qbmx_pt_heatbath,
        J.data_ptr(), h.data_ptr(), betas.data_ptr(), dbeta.data_ptr(), *variates,
        out.data_ptr(), B, M, R, n, S, seed, layout.lanes, kernel_call.stream(dev))
    launch_counts["pt_heatbath"] += 1
    return out
