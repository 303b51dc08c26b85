"""What the CUDA kernel wrappers (``sa_cuda``, ``gibbs_cuda``, ``wide_cuda``,
``pt_cuda``) share: the checks of the arguments they pass, the boundary
between the anneal kernels that hold a group's couplings in shared memory
and the one that streams them, the layout rule of the two that hold them
(K1 and K2, :func:`chain_layout`), the stream, and the launch's return
code.  Each wrapper makes its own launch call and counts its own launches."""

from __future__ import annotations

import dataclasses
import math

import torch

# one block's shared memory on Hopper (227 KB)
SMEM_BYTES = 232_448
# streaming multiprocessors of an H100 SXM: the launch-geometry rules
# (chain_layout, wide_cuda.wide_geometry, pt_cuda.pt_layout) size their
# layouts by it
NUM_SMS = 132
THREADS = 128  # threads a block of K1 and K2 (sa_metropolis.cu, sa_heatbath.cu kThreads)
THREAD_MAX_N = 8  # widest THREAD layout: fully unrolled, state and fields in registers


def fits_shared(n: int) -> bool:
    """Whether a group's couplings J_g ((n, n) float32) fit one block's
    shared memory, i.e. n ≤ 241.  The anneal wrappers launch K1
    (``sa_metropolis.cu``) or K2 (``sa_heatbath.cu``) when they do and K4
    (``anneal_wide.cu``), which streams J_g in row tiles, when they do not."""
    return 4 * n * n <= SMEM_BYTES


@dataclasses.dataclass(frozen=True)
class ChainLayout:
    lanes: int  # threads per chain: 1 (THREAD layout) or 32 (LANES layout)
    slots: int  # variables a thread owns: n (THREAD), else ⌈n / lanes⌉ up to a power of 2
    chains_per_block: int
    smem: int  # bytes per block: J_g
    grid: tuple  # (blocks per group, groups)


def chain_layout(G: int, B: int, R: int, n: int, lanes: int | None = None) -> ChainLayout:
    """The layout of K1 (``sa_metropolis.cu``) and K2 (``sa_heatbath.cu``)
    for G groups of B problems, R reads, width n: one rule for both.

    Rule: one thread per chain (``lanes`` 1, the THREAD layout) at n ≤ 8
    when the chains are many, G·B·R > 4,224 (= 32·132: more than a warp a
    chain could place at 32 warps per SM); it does the least work a
    decision while the chains fill the card's issue slots.  Otherwise a
    chain is spread over a warp (``lanes`` 32, the LANES layout), so that
    a decision's latency, not a dot product, sets a variable's cost.
    ``lanes`` overrides the choice (for checks of a layout; the sampler
    paths never pass it).  Both layouts hold J_g (4n² bytes ≤ 232,448:
    n ≤ 241) in shared memory, in blocks of 128 threads."""
    if not fits_shared(n):
        raise ValueError(f"K1/K2 layout: n={n} exceeds its bound (n ≤ 241)")
    if lanes is None:
        lanes = 1 if n <= THREAD_MAX_N and G * B * R > 32 * NUM_SMS else 32
    if lanes not in (1, 32) or (lanes == 1 and n > THREAD_MAX_N):
        raise ValueError(f"K1/K2 layout: no layout with {lanes} lanes at n={n}")
    slots = n if lanes == 1 else 1 << (math.ceil(n / lanes) - 1).bit_length()
    per_block = THREADS // lanes
    return ChainLayout(lanes, slots, per_block, 4 * n * n, (math.ceil(B * R / per_block), G))


def require(t: torch.Tensor, name: str, shape: tuple, device: torch.device,
            dtype: torch.dtype = torch.float32) -> None:
    """Refuse what a kernel cannot read: another device, dtype, shape or a
    non-contiguous layout."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: need a contiguous {str(dtype).removeprefix('torch.')} tensor of shape "
            f"{shape} on {device}; "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            f"{'' if t.is_contiguous() else ' (not contiguous)'}")


def variate_ptrs(host_variates, specs: tuple, device: torch.device) -> tuple:
    """Device pointers of ``host_variates`` checked against ``specs``
    ((name, shape), ...); all null in generator mode."""
    if host_variates is None:
        return (None,) * len(specs)
    if len(host_variates) != len(specs):
        raise ValueError(f"host_variates: need ({', '.join(name for name, _ in specs)})")
    for t, (name, shape) in zip(host_variates, specs):
        require(t, name, shape, device)
    return tuple(t.data_ptr() for t in host_variates)


def structured_ptrs(kernel: str, max_n: int | None, J, h, hot, logr, num_reads: int,
                    num_sweeps: int, host_variates) -> tuple:
    """Check the structured form of an anneal kernel (``J`` (G, n, n),
    ``h`` (G, B, n), ``hot``/``logr`` (G, B), ``host_variates`` (init01
    (G, B, R, n), uniforms (S, G, B, n, R))) against its widest n
    (``max_n``; None: no bound) and return its six pointers."""
    G, B, n = h.shape
    dev = h.device
    for t, name, shape in ((J, "J", (G, n, n)), (h, "h", (G, B, n)),
                           (hot, "beta_hot", (G, B)), (logr, "logr", (G, B))):
        require(t, name, shape, dev)
    if max_n is not None and n > max_n:
        raise ValueError(f"{kernel} kernel: n={n} exceeds its bound (n ≤ {max_n})")
    if G > 65535:
        raise ValueError(f"{kernel} kernel: {G} groups exceed the grid's 65535")
    R, S = num_reads, num_sweeps
    variates = variate_ptrs(host_variates, (("init01", (G, B, R, n)),
                                            ("uniforms", (S, G, B, n, R))), dev)
    return (J.data_ptr(), h.data_ptr(), hot.data_ptr(), logr.data_ptr(), *variates)


def optional_ptr(t: torch.Tensor | None, name: str, shape: tuple, dtype: torch.dtype,
                 device: torch.device):
    """Device pointer of an optional output of a kernel (null for None)."""
    if t is None:
        return None
    require(t, name, shape, device, dtype)
    return t.data_ptr()


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_rc(kernel: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError {rc}")
