"""What the CUDA kernel wrappers (``sa_cuda``, ``gibbs_cuda``, ``wide_cuda``,
``pt_cuda``) share: the checks of the arguments they pass, the boundary
between the anneal kernels that hold a group's couplings in shared memory
and the one that streams them, the layout rule of the two that hold them
(K1 and K2, :func:`chain_layout`), the stream, and the launch's return
code.  Each wrapper makes its own launch call (through :func:`call`, which
opens the ``sampler.launch`` span) and counts its own launches."""

from __future__ import annotations

import dataclasses
import math

import torch

from qbmx_torch.utils.spans import span

# one block's shared memory on Hopper (227 KB)
SMEM_BYTES = 232_448
# streaming multiprocessors of an H100 SXM: the launch-geometry rules
# (chain_layout, wide_cuda.wide_geometry, pt_cuda.pt_layout) size their
# layouts by it
NUM_SMS = 132
THREADS = 128  # threads a block of K1 and K2 (sa_metropolis.cu, sa_heatbath.cuh kThreads)
# widest THREAD layout: one fully unrolled instance a width, the state and
# h in registers (sa_metropolis.cu, sa_heatbath.cuh kThreadMaxN)
THREAD_MAX_N = 32
LANES = (4, 8, 16, 32)  # lanes a chain of GROUP (4, 8, 16) and LANES (32)
# the most variables a lane of GROUP and LANES owns (the kernels' slot bound
# K; a warp a chain covers n = 241 with 8)
MAX_SLOTS = 8
QUAD_MIN_LANES = 16  # K2 quad spreads its 16 joint states over 16 lanes
METROPOLIS = 0  # the update width K1 passes to chain_layout (K2: 1, 2 or 4)
# The rule's boundaries, by update width, from the card
# (``cli/compare_kernels.py --parts layouts``, PERF.md §5): THREAD from this
# many chains a variable on, at most ``THREAD_MIN_CHAINS`` (fewer threads
# leave a chain of decisions latency bound; K1 and heat-bath single lead
# GROUP from ~1,500 chains a variable at n ≤ 8 and from 16,000 past it) ...
THREAD_CHAINS_A_VARIABLE = {METROPOLIS: 1_500, 1: 1_500, 2: 4_224, 4: 4_224}
THREAD_MIN_CHAINS = {METROPOLIS: 16_000, 1: 16_000, 2: 4_224, 4: 4_224}
# ... and at any count up to this n (pair and quad: their exact joint
# conditionals make a decision dear enough on every layout)
THREAD_ANY_CHAINS_N = {METROPOLIS: 0, 1: 0, 2: 12, 4: 16}
# GROUP takes the fewest lanes a chain whose chains put this many lanes on
# the card (about 8 warps a SM) and whose slots, at most this many by update
# width, hold n (heat-bath single at n = 41: 16 lanes, 3 slots, 0.80 ms
# against 8 lanes' 1.07); fewer chains take a warp a chain
FILL_LANES = 32_000
GROUP_MAX_SLOTS = {METROPOLIS: MAX_SLOTS, 1: 4, 2: MAX_SLOTS, 4: MAX_SLOTS}


def fits_shared(n: int) -> bool:
    """Whether a group's couplings J_g ((n, n) float32) fit one block's
    shared memory, i.e. n ≤ 241.  The anneal wrappers launch K1
    (``sa_metropolis.cu``) or K2 (``sa_heatbath.cu``) when they do and K4
    (``anneal_wide.cu``), which streams J_g in row tiles, when they do not."""
    return 4 * n * n <= SMEM_BYTES


def max_n(lanes: int, width: int = METROPOLIS) -> int:
    """The widest n K1 and K2 (update ``width``) take at ``lanes`` lanes a
    chain (0: none, as quad below 16 lanes)."""
    if lanes == 1:
        return THREAD_MAX_N
    if lanes not in LANES or (width == 4 and lanes < QUAD_MIN_LANES):
        return 0
    return min(241, lanes * MAX_SLOTS)


@dataclasses.dataclass(frozen=True)
class ChainLayout:
    lanes: int  # threads per chain: 1 (THREAD), 4, 8, 16 (GROUP) or 32 (LANES)
    slots: int  # variables a thread owns: n (THREAD), else ⌈n / lanes⌉ up to a power of 2
    chains_per_block: int
    smem: int  # bytes per block: J_g
    grid: tuple  # (blocks per group, groups)

    @property
    def route(self) -> str:
        """The layout's name in the records: "a thread a chain", "L lanes a
        chain" or "a warp a chain"."""
        if self.lanes == 1:
            return "a thread a chain"
        return "a warp a chain" if self.lanes == 32 else f"{self.lanes} lanes a chain"


def chain_layout(G: int, B: int, R: int, n: int, lanes: int | None = None,
                 width: int = METROPOLIS) -> ChainLayout:
    """The layout of K1 (``sa_metropolis.cu``, ``width`` 0) and K2
    (``sa_heatbath.cu``, update ``width`` 1, 2 or 4) for G groups of B
    problems, R reads, width n: one rule for both, whose boundaries the
    card measured (``cli/compare_kernels.py --parts layouts``, PERF.md §5).

    Rule: one thread per chain (``lanes`` 1, the THREAD layout) at
    n ≤ ``THREAD_MAX_N`` when the chains are many, G·B·R ≥
    min(``THREAD_MIN_CHAINS``, ``THREAD_CHAINS_A_VARIABLE``·n) at the
    update width, or for pair and quad at any count up to
    n = ``THREAD_ANY_CHAINS_N``: it does the fewest instructions a decision
    while the chains fill the card's issue slots.  Otherwise a chain is
    spread over L lanes of a warp, so that a decision's latency, not a dot
    product, sets a variable's cost: the fewest L of 4, 8, 16 (GROUP)
    whose chains put ``FILL_LANES`` lanes on the card and whose
    ``GROUP_MAX_SLOTS[width]`` slots hold n, else 32 (LANES, a warp a
    chain: the most SMs for few chains).  Quad takes at least 16 lanes.
    ``lanes`` overrides the choice (for checks and timings of a layout; the
    sampler paths never pass it).  Every layout holds J_g (4n² bytes ≤
    232,448: n ≤ 241) in shared memory, in blocks of 128 threads."""
    if not fits_shared(n):
        raise ValueError(f"K1/K2 layout: n={n} exceeds its bound (n ≤ 241)")
    if width not in THREAD_MIN_CHAINS:
        raise ValueError(f"K1/K2 layout: unknown update width {width}")
    chains = G * B * R
    if lanes is None:
        few = min(THREAD_MIN_CHAINS[width], THREAD_CHAINS_A_VARIABLE[width] * n)
        if n <= THREAD_MAX_N and (chains >= few or n <= THREAD_ANY_CHAINS_N[width]):
            lanes = 1
        else:
            lanes = next((L for L in LANES[:-1]
                          if n <= min(max_n(L, width), L * GROUP_MAX_SLOTS[width])
                          and chains * L >= FILL_LANES), 32)
    if n > max_n(lanes, width):
        raise ValueError(f"K1/K2 layout: no layout with {lanes} lanes at n={n}"
                         + (" for quad" if width == 4 else ""))
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


def call(kernel: str, fn, *args) -> None:
    """The library's launch ``fn(*args)`` of ``kernel`` inside the
    ``sampler.launch`` span, its return code checked."""
    with span("sampler.launch"):
        rc = fn(*args)
    check_rc(kernel, rc)
