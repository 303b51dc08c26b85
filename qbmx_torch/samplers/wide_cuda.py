"""Wrapper of the CUDA anneal kernel for wide QUBOs (``qbmx_torch/csrc/
anneal_wide.cu``, K4).

K4 computes what K1 (``sa_metropolis.cu``) and K2 (``sa_heatbath.cu``)
compute, on the same structured form (``J`` (G, n, n), ``h`` (G, B, n),
schedule ``hot``/``logr`` (G, B) → (G, B, R, n)), for the widths whose
couplings do not fit one block's shared memory.  ``sa_cuda`` and
``gibbs_cuda`` call :func:`launch` when ``kernel_call.fits_shared(n)`` is
false; its plain versions are theirs (``sa_torch``, ``gibbs``).  Its
launches are counted here, apart from K1's and K2's, so a run shows which
kernel served it.  :func:`wide_geometry` is the launch's geometry (chains
per block, a warp each, and shared memory), the one rule the kernel is
launched by.

In generator mode K4 draws the Philox streams of K1 and K2
(``sa_torch.philox_variates`` writes them out); ``host_variates``
``(init01 (G,B,R,n), uniforms (S,G,B,n,R))`` replace them.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch
import torch.nn.functional as F

from qbmx_torch.core.rng import draw_seed
from qbmx_torch.samplers import kernel_call
from qbmx_torch.samplers.sa_torch import inv_span

#: the kernel's ``rule`` argument: Metropolis, or heat-bath at update width 1, 2, 4
METROPOLIS, HEATBATH, PAIR, QUAD = 0, 1, 2, 4

#: launches of K4 since the last reset (one per call that reached the GPU)
launch_counts = {"anneal_wide": 0}

TILE_ROWS = 8  # J rows per shared-memory tile (anneal_wide.cu kRows)
REFRESH_PERIOD = 64  # sweeps between recomputations of the fields (kRefreshPeriod)
LANES = 32  # threads a chain: a warp (kLanes)
MAX_CHAINS = 32  # chains per block: 1024 threads (kMaxChains)


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def field_drift_bound(h: torch.Tensor, J: torch.Tensor, num_sweeps: int,
                      period: int = REFRESH_PERIOD) -> torch.Tensor:
    """(G, B, 1, n) float64 limit on |f_j − (h_j + Σ_k J_jk s_k)| for the
    final fields of a K4 run of ``num_sweeps`` sweeps, √A·2^-24·M_j; with
    ``period`` the refresh period of another kernel with incremental fields
    (K2's LANES layout: ``gibbs_cuda.REFRESH_PERIOD``), for its run.

    A field is recomputed at the last refresh sweep (n terms and h) and then
    takes at most one add of ±J_jk per decision since (n a sweep): at most
    A = n + 1 + n·(sweeps since the refresh) adds, each rounding by at most
    2^-24 of a partial sum bounded by M_j = |h_j| + Σ_k |J_jk|.  The worst
    case, A·2^-24·M_j, is ~A/n typical |J_jk| on a dense QUBO, so a field
    that lost or doubled one add would pass it.  Roundings of either sign
    add as a random walk, so their sum stays near √A roundings of M_j;
    this limit is that, a statistical bound, not a worst case.  A lost add
    of |J_jk| exceeds it unless |J_jk| < √A·2^-24·M_j (at n=717 and 40
    sweeps since the refresh, ~1% of a typical |J_jk|)."""
    n = h.shape[-1]
    since = num_sweeps - period * ((num_sweeps - 1) // period)
    scale = h.double().abs() + J.double().abs().sum(-1)[:, None, :]
    return (math.sqrt(n + 1 + n * since) * 2.0**-24 * scale)[:, :, None, :]


def row_floats(n: int) -> int:
    """Floats per padded J row: n rounded up to 4 (16-byte rows)."""
    return -(-n // 4) * 4


def smem_bytes(n: int, chains: int) -> int:
    """A block's shared memory at width n with ``chains`` chains: two J
    tiles of 8 rows (n rounded up to 4 floats a row), then each chain's
    fields and state bytes (n rounded up to 8, whole tiles) —
    ``anneal_wide.cu``'s Layout."""
    frow = -(-n // TILE_ROWS) * TILE_ROWS
    return 4 * (2 * TILE_ROWS * row_floats(n) + chains * (frow + frow // 4))


def max_n() -> int:
    """Largest n K4 takes: one chain's fields and state beside two tiles
    fit one block (``qbmx_anneal_wide_max_n``)."""
    n = 1
    while smem_bytes(n + 1, 1) <= kernel_call.SMEM_BYTES:
        n += 1
    return n


@dataclasses.dataclass(frozen=True)
class WideGeometry:
    chains_per_block: int
    threads: int  # per block
    smem: int  # bytes per block
    grid: tuple  # (blocks per group, groups)

    @classmethod
    def of(cls, G: int, B: int, R: int, n: int, chains: int) -> "WideGeometry":
        return cls(chains, LANES * chains, smem_bytes(n, chains), (math.ceil(B * R / chains), G))


def wide_geometry(G: int, B: int, R: int, n: int) -> WideGeometry:
    """K4's launch geometry for G groups of B problems, R reads, width n.

    Rule: a chain gets a warp.  A block holds C chains of one group, C =
    ⌈G·B·R / 132⌉ (one block per SM when the chains allow), at most 32 (1024
    threads) and at most what shared memory holds (:func:`smem_bytes` ≤
    232,448 bytes).  The grid is (⌈B·R / C⌉, G)."""
    if n > max_n():
        raise ValueError(f"anneal_wide kernel: n={n} exceeds its bound (n ≤ {max_n()})")
    fit = max(c for c in range(1, MAX_CHAINS + 1) if smem_bytes(n, c) <= kernel_call.SMEM_BYTES)
    C = max(1, min(math.ceil(G * B * R / kernel_call.NUM_SMS), MAX_CHAINS, fit))
    return WideGeometry.of(G, B, R, n, C)


def launch(J: torch.Tensor, h: torch.Tensor, hot: torch.Tensor, logr: torch.Tensor,
           num_reads: int, num_sweeps: int, rule: int, *,
           generator: torch.Generator | None = None, host_variates=None,
           fields_out: torch.Tensor | None = None, flips: torch.Tensor | None = None,
           geometry: WideGeometry | None = None) -> torch.Tensor:
    """Launch K4 on the structured form: ``J`` (G, n, n) symmetric
    zero-diagonal couplings, ``h`` (G, B, n) linear terms, ``hot``/``logr``
    (G, B) the schedule ``β_t = hot·exp(logr·t/(S−1))``, ``rule`` one of
    :data:`METROPOLIS`, :data:`HEATBATH`, :data:`PAIR`, :data:`QUAD` →
    (G, B, R, n) samples in {0, 1}.  Any width the kernel takes, so callers
    (and checks of the kernel itself) may send it narrow problems too.

    ``fields_out`` ((G, B, R, n) float32) receives the final local fields,
    ``flips`` ((2,) int64, added to) the number of variables changed and
    the nonzeros of their rows (the work of the changes on a sparse J), and
    ``geometry`` replaces :func:`wide_geometry`'s choice; all three are for
    checks of the kernel, and the sampler paths pass none."""
    from qbmx_torch._build import load_kernels

    if rule not in (METROPOLIS, HEATBATH, PAIR, QUAD):
        raise ValueError(f"anneal_wide kernel: unknown rule {rule}")
    lib = load_kernels()
    G, B, n = h.shape
    R, S = num_reads, num_sweeps
    ptrs = kernel_call.structured_ptrs("anneal_wide", lib.qbmx_anneal_wide_max_n(),
                                       J, h, hot, logr, R, S, host_variates)
    geo = geometry or wide_geometry(G, B, R, n)
    Jp = F.pad(J, (0, row_floats(n) - n)).contiguous()  # 16-byte rows for cp.async
    seed = draw_seed(generator) if host_variates is None else 0
    out = torch.empty((G, B, R, n), dtype=torch.float32, device=h.device)
    fptr = kernel_call.optional_ptr(fields_out, "fields_out", (G, B, R, n), torch.float32,
                                    h.device)
    cptr = kernel_call.optional_ptr(flips, "flips", (2,), torch.int64, h.device)
    nnz = None if flips is None else (J != 0).sum(-1, dtype=torch.int32)  # (G, n)
    kernel_call.check_rc("anneal_wide", lib.qbmx_anneal_wide(
        Jp.data_ptr(), None if nnz is None else nnz.data_ptr(), *ptrs[1:], out.data_ptr(), fptr,
        cptr, G, B, R, n, S,
        ctypes.c_float(inv_span(S)), seed, rule, geo.chains_per_block,
        kernel_call.stream(h.device)))
    launch_counts["anneal_wide"] += 1
    return out
