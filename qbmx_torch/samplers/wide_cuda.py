"""Wrapper of the CUDA anneal kernel for wide QUBOs (``qbmx_torch/csrc/
anneal_wide.cu``, K4).

K4 computes what K1 (``sa_metropolis.cu``) and K2 (``sa_heatbath.cu``)
compute, on the same structured form (``J`` (G, n, n), ``h`` (G, B, n),
schedule ``hot``/``logr`` (G, B) → (G, B, R, n)), for the widths whose
couplings do not fit one block's shared memory.  ``sa_cuda`` and
``gibbs_cuda`` call :func:`launch` when ``kernel_call.fits_shared(n)`` is
false; its plain versions are theirs (``sa_torch``, ``gibbs``).  Its
launches are counted here, apart from K1's and K2's and by layout, so a
run shows which kernel served it.  :func:`wide_geometry` is the launch's
geometry (layout, chains per block, a warp each, and shared memory), the
one rule the kernel is launched by.

Two layouts, one semantics and the same fields bit for bit: the shared
layout keeps each chain's fields and state in shared memory, at most
:func:`max_n` (3368) wide, beside two J tiles (the dense path,
``anneal_wide.cu``) or, where :func:`shared_path` finds J_g sparse, beside
J_g's row lists and a table of the couplings within a unit (the sparse
path, ``anneal_wide_sparse.cu``: a change adds only its row's nonzeros,
no block barrier follows the lists' copy, and outside the refresh sweeps
a chain's warp decides a batch's units at once and commits their changes
in order), counted apart; the
global-field layout keeps them in a scratch buffer in global memory that
:func:`launch` allocates (a row of n rounded up to 8 floats and as many
bytes a chain) and walks J_g in windows of :data:`WINDOW` rows, at any
width the card's memory holds:
a window's fields are read once into shared memory beside its diagonal
block, and its changes reach the chain's other fields in one pass -- the
dense pass, streaming the window's rows of J_g, or, where :func:`sparse_pass`
finds J_g sparse, the sparse pass over the changed rows' nonzeros
(``pt_wide_cuda.row_lists``), counted apart.  The rule takes the shared
layout up to :func:`switch_n` (1056), where a block still holds 31 chains,
and the global one past it.

In generator mode K4 draws the Philox streams of K1 and K2
(``sa_torch.philox_variates`` writes them out); ``host_variates``
``(init01 (G,B,R,n), uniforms (S,G,B,n,R))`` replace them.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch
import torch.nn.functional as F

from qbmx_torch.core.rng import draw_seed
from qbmx_torch.samplers import kernel_call
from qbmx_torch.samplers.sa_torch import inv_span

#: the kernel's ``rule`` argument: Metropolis, or heat-bath at update width 1, 2, 4
METROPOLIS, HEATBATH, PAIR, QUAD = 0, 1, 2, 4

#: launches of K4 since the last reset (one per call that reached the GPU), by layout
#: and path: the shared layout's dense and sparse paths, the global-field layout's
#: dense and sparse passes
launch_counts = {"anneal_wide": 0, "anneal_wide_sparse": 0, "anneal_wide_global": 0,
                 "anneal_wide_global_sparse": 0}

SHARED, GLOBAL = "shared", "global"  # where a chain's fields and state live
DENSE, SPARSE = "dense", "sparse"  # how a change reaches the fields: J_g's rows, or its nonzeros

TILE_ROWS = 8  # J rows per shared-memory tile (anneal_wide.cu kRows)
REFRESH_PERIOD = 64  # sweeps between recomputations of the fields (kRefreshPeriod)
LANES = 32  # threads a chain: a warp (kLanes)
MAX_CHAINS = 32  # chains per block: 1024 threads (kMaxChains)
WINDOW = 128  # rows a window of the global-field layout (kWin), and columns a dense chunk
SWITCH_CHAINS = 31  # the fewest chains a block the rule gives the shared layout
#: the global-field layout's sparse pass takes a call whose densest group's
#: J_g holds at most this share of nonzeros (:func:`sparse_pass`)
SPARSE_DENSITY = 0.01
MAX_SPARSE_N = 32768  # the row lists' 16-bit columns
#: the shared layout's sparse path takes a call whose densest group's J_g
#: holds at most this share of nonzeros (:func:`shared_path`, which says
#: where the card measured it)
SHARED_SPARSE_DENSITY = 0.04
UNIT_STRIDE = 3  # the unit table's couplings a variable: J_{i,i+1}, J_{i,i+2}, J_{i,i+3}


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


@functools.cache
def max_n() -> int:
    """Widest n of the shared layout, where one chain's fields and state
    beside two tiles fit one block (``qbmx_anneal_wide_max_n``)."""
    n = 1
    while smem_bytes(n + 1, 1) <= kernel_call.SMEM_BYTES:
        n += 1
    return n


@functools.cache
def switch_n() -> int:
    """Widest n the rule gives the shared layout: where a block still holds
    :data:`SWITCH_CHAINS` chains (1056).  Measured on an H100 with both
    layouts forced on 4,000 chains (``chip_smoke.py`` phase 10's turns,
    after the global-field layout's windows and sparse pass): the shared
    layout is 8-20% faster at n = 1024 and 1056 (31 chains a block, the
    4,000 chains in one wave of 130 blocks) and 37-40% slower at n = 1057
    (30 chains a block: a second wave), 25-36% from n = 1280."""
    n = 1
    while smem_bytes(n + 1, SWITCH_CHAINS) <= kernel_call.SMEM_BYTES:
        n += 1
    return n


def global_row_floats(n: int) -> int:
    """Floats per padded J row and per chain's fields (and bytes of its
    state) in the global-field layout: n rounded up to 8, so a tile's
    diagonal block stays inside its rows."""
    return -(-n // TILE_ROWS) * TILE_ROWS


def global_smem_bytes(chains: int, sparse: bool = False) -> int:
    """A global-field block's shared memory at any width: the window's
    :data:`WINDOW` × :data:`WINDOW` diagonal block, on the dense pass two
    chunks of as many floats, and each chain's window fields, state bytes
    and change list (``qbmx_anneal_wide_global_smem``)."""
    return 4 * WINDOW * WINDOW * (1 if sparse else 3) + chains * 6 * WINDOW


def sparse_pass(counts: torch.Tensor, n: int) -> bool:
    """The density rule of the global-field layout (K4's and K5's): its
    sparse pass where the densest group's J_g holds at most
    :data:`SPARSE_DENSITY` · n² nonzeros (``counts``: J_g's nonzeros a row,
    (G, n), ``pt_wide_cuda.row_nnz``) and the row lists' columns fit 16 bits
    (n ≤ 32768), else the dense pass."""
    return n <= MAX_SPARSE_N and int(counts.sum(-1).max()) <= SPARSE_DENSITY * n * n


def units_len(n: int) -> int:
    """Floats of a group's unit table: :data:`UNIT_STRIDE` · n rounded up
    to 4 (16-byte copies)."""
    return -(-(UNIT_STRIDE * n) // 4) * 4


def unit_couplings(J: torch.Tensor) -> torch.Tensor:
    """(G, :func:`units_len`) float32: J_g[i, i+k] at 3i + k − 1 for k = 1,
    2, 3 (zero past n), the couplings within the pair or quad that holds
    variable i, copied from J (G, n, n) for the sparse path's decisions."""
    G, n, _ = J.shape
    out = torch.zeros((G, units_len(n)), dtype=torch.float32, device=J.device)
    table = out[:, :UNIT_STRIDE * n].view(G, n, UNIT_STRIDE)
    for k in range(1, UNIT_STRIDE + 1):
        table[:, :max(n - k, 0), k - 1] = torch.diagonal(J, offset=k, dim1=1, dim2=2)
    return out


def sparse_smem_bytes(n: int, chains: int, nnz_pad: int) -> int:
    """A sparse-path block's shared memory: the group's row lists (nnz_pad
    fp32 values and 16-bit columns, the offsets), its unit table, then each
    chain's fields and state bytes as on the dense path
    (``qbmx_anneal_wide_sparse_smem``)."""
    from qbmx_torch.samplers.pt_wide_cuda import offsets_len

    return (6 * nnz_pad + 4 * offsets_len(n) + 4 * units_len(n) + smem_bytes(n, chains)
            - smem_bytes(n, 0))


def shared_path(nnz: tuple, n: int, chains: int) -> str:
    """The shared layout's path at width n with ``chains`` chains a block,
    from J_g's nonzeros a group (``pt_wide_cuda.group_nnz``): :data:`SPARSE`
    where the densest group holds at most :data:`SHARED_SPARSE_DENSITY` ·
    n² nonzeros and its row lists (``pt_wide_cuda.padded``) fit a block
    beside the chains (:func:`sparse_smem_bytes`), else :data:`DENSE`.

    The tie was measured on an H100 (``cli/compare_kernels.py --parts
    sparse_density``: both paths forced, in turns, Metropolis and pair, at
    n = 301, 384, 512 and 717 on 4,000, 14,600 and 40,000 chains, J_g
    0.5-8% nonzeros): the sparse path was faster in every cell up to 4%
    (at most 0.933 of the dense path's time: n = 301, 4,000 chains,
    Metropolis) and slower only at 8% there (1.071; 0.996 at n = 384), so
    the tie lies near 6% at n = 301 and past 8% from n = 512 on; 4% is the
    largest share measured at which it won everywhere.  CDQBM (a) holds
    1.96%, the restricted flat model 2/n."""
    from qbmx_torch.samplers.pt_wide_cuda import padded

    top = max(nnz)
    if top <= SHARED_SPARSE_DENSITY * n * n \
            and sparse_smem_bytes(n, chains, padded(top)) <= kernel_call.SMEM_BYTES:
        return SPARSE
    return DENSE


@dataclasses.dataclass(frozen=True)
class WideGeometry:
    chains_per_block: int
    threads: int  # per block
    smem: int  # bytes per block (the global-field layout: with the dense pass)
    grid: tuple  # (blocks per group, groups)
    layout: str = SHARED  # SHARED or GLOBAL

    @classmethod
    def of(cls, G: int, B: int, R: int, n: int, chains: int,
           layout: str | None = None) -> "WideGeometry":
        """``chains`` chains a block in ``layout`` (default: the shared
        layout up to :func:`max_n`, the global-field one past it)."""
        layout = layout or (SHARED if n <= max_n() else GLOBAL)
        grid = (math.ceil(B * R / chains), G)
        if layout == SHARED:
            return cls(chains, LANES * chains, smem_bytes(n, chains), grid)
        if layout != GLOBAL:
            raise ValueError(f"anneal_wide kernel: unknown layout {layout!r}")
        return cls(chains, LANES * chains, global_smem_bytes(chains), grid, GLOBAL)


def layout_geometry(G: int, B: int, R: int, n: int, layout: str) -> WideGeometry:
    """K4's launch geometry in ``layout``: C = ⌈G·B·R / 132⌉ chains a block
    (one block per SM when the chains allow), at most 32 (1024 threads),
    and in the shared layout also at most what shared memory holds
    (:func:`smem_bytes` ≤ 232,448 bytes; n ≤ :func:`max_n`)."""
    C = max(1, min(math.ceil(G * B * R / kernel_call.NUM_SMS), MAX_CHAINS))
    if layout == SHARED:
        fit = [c for c in range(1, MAX_CHAINS + 1) if smem_bytes(n, c) <= kernel_call.SMEM_BYTES]
        if not fit:
            raise ValueError(f"anneal_wide kernel: n={n} exceeds the shared layout's bound "
                             f"(n ≤ {max_n()})")
        C = min(C, max(fit))
    return WideGeometry.of(G, B, R, n, C, layout)


def wide_geometry(G: int, B: int, R: int, n: int) -> WideGeometry:
    """K4's launch geometry for G groups of B problems, R reads, width n.

    Rule: a chain gets a warp, :func:`layout_geometry`'s chains a block,
    on a grid of (⌈B·R / C⌉, G).  Up to n = :func:`switch_n` (1056) the
    shared layout; past it the global-field layout, whose shared memory
    holds a window's rows (:func:`global_smem_bytes`)."""
    return layout_geometry(G, B, R, n, SHARED if n <= switch_n() else GLOBAL)


def launch(J: torch.Tensor, h: torch.Tensor, hot: torch.Tensor, logr: torch.Tensor,
           num_reads: int, num_sweeps: int, rule: int, *,
           generator: torch.Generator | None = None, host_variates=None,
           fields_out: torch.Tensor | None = None, flips: torch.Tensor | None = None,
           geometry: WideGeometry | None = None, field_pass: str | None = None,
           dense_couplings: bool = False) -> torch.Tensor:
    """Launch K4 on the structured form: ``J`` (G, n, n) symmetric
    zero-diagonal couplings, ``h`` (G, B, n) linear terms, ``hot``/``logr``
    (G, B) the schedule ``β_t = hot·exp(logr·t/(S−1))``, ``rule`` one of
    :data:`METROPOLIS`, :data:`HEATBATH`, :data:`PAIR`, :data:`QUAD` →
    (G, B, R, n) samples in {0, 1}.  Any width, so callers (and checks of
    the kernel itself) may send it narrow problems too.  The shared layout
    takes the path :func:`shared_path` picks on J's nonzeros, the
    global-field layout the pass :func:`sparse_pass` picks.

    ``fields_out`` ((G, B, R, n) float32) receives the final local fields,
    ``flips`` ((2,) int64, added to) the number of variables changed and
    the nonzeros of their rows (the work of the changes on a sparse J),
    ``geometry`` replaces :func:`wide_geometry`'s choice, and ``field_pass``
    (:data:`DENSE` or :data:`SPARSE`) the rule's path or pass; all four are
    for checks of the kernel, and the sampler paths pass none.  A forced
    sparse path whose row lists do not fit a block raises.

    ``dense_couplings``: the caller knows J_g dense (the flat model's ``-r
    False`` ``w_hh``), where the rules take the dense path or pass anyway;
    they are then not asked, so J's nonzeros are not counted and the host
    does not wait on the card for their count before the launch."""
    from qbmx_torch._build import load_kernels
    from qbmx_torch.samplers import pt_wide_cuda

    if rule not in (METROPOLIS, HEATBATH, PAIR, QUAD):
        raise ValueError(f"anneal_wide kernel: unknown rule {rule}")
    if field_pass not in (None, DENSE, SPARSE):
        raise ValueError(f"anneal_wide kernel: unknown field pass {field_pass!r}")
    lib = load_kernels()
    G, B, n = h.shape
    R, S = num_reads, num_sweeps
    ptrs = kernel_call.structured_ptrs("anneal_wide", None, J, h, hot, logr, R, S,
                                       host_variates)
    geo = geometry or wide_geometry(G, B, R, n)
    glob = geo.layout == GLOBAL
    if not glob and n > lib.qbmx_anneal_wide_max_n():
        raise ValueError(f"anneal_wide kernel: n={n} exceeds the shared layout's bound "
                         f"(n ≤ {max_n()})")
    path = DENSE if dense_couplings and field_pass is None else field_pass
    # J's nonzeros, for the rules, the sparse path or pass and the counting build
    counts = pt_wide_cuda.row_nnz(J) if path != DENSE or flips is not None else None
    nnz = None
    if glob:
        sparse = sparse_pass(counts, n) if path is None else path == SPARSE
        if sparse and n > MAX_SPARSE_N:
            raise ValueError(f"anneal_wide kernel: the sparse pass takes n ≤ {MAX_SPARSE_N}")
    else:
        C = geo.chains_per_block
        nnz = None if path == DENSE else pt_wide_cuda.group_nnz(counts)
        sparse = (path or shared_path(nnz, n, C)) == SPARSE
        if sparse and sparse_smem_bytes(n, C, pt_wide_cuda.padded(max(nnz))) \
                > kernel_call.SMEM_BYTES:
            raise ValueError(f"anneal_wide kernel: J_g's row lists ({max(nnz)} nonzeros) do not "
                             f"fit a block beside {C} chains at n={n}")
    rows = pt_wide_cuda.row_lists(J, counts, nnz) if sparse else None
    seed = draw_seed(generator) if host_variates is None else 0
    out = torch.empty((G, B, R, n), dtype=torch.float32, device=h.device)
    fptr = kernel_call.optional_ptr(fields_out, "fields_out", (G, B, R, n), torch.float32,
                                    h.device)
    cptr = kernel_call.optional_ptr(flips, "flips", (2,), torch.int64, h.device)
    tail = (G, B, R, n, S, ctypes.c_float(inv_span(S)), seed, rule, geo.chains_per_block,
            kernel_call.stream(h.device))
    if sparse and not glob:
        units = unit_couplings(J)
        kernel_call.call("anneal_wide_sparse", lib.qbmx_anneal_wide_sparse,
            rows.vals.data_ptr(), rows.cols.data_ptr(), rows.offsets.data_ptr(),
            units.data_ptr(), *ptrs[1:], out.data_ptr(), fptr, cptr, rows.nnz_pad, *tail)
        launch_counts["anneal_wide_sparse"] += 1
        return out
    # rows padded to 16 bytes for cp.async (to 32 in the global-field layout)
    Jp = F.pad(J, (0, (global_row_floats(n) if glob else row_floats(n)) - n)).contiguous()
    fscr = sscr = None
    if glob:  # each chain's fields and state bytes, a row each
        fscr = torch.zeros((G * B * R, global_row_floats(n)), dtype=torch.float32,
                           device=h.device)
        sscr = torch.zeros((G * B * R, global_row_floats(n)), dtype=torch.uint8,
                           device=h.device)
    lists = (None, None, None, 0) if rows is None else (
        rows.vals.data_ptr(), rows.cols.data_ptr(), rows.offsets.data_ptr(), rows.nnz_pad)
    kernel_call.call("anneal_wide", lib.qbmx_anneal_wide,
        Jp.data_ptr(), None if flips is None else counts.data_ptr(), *ptrs[1:], out.data_ptr(),
        fptr, cptr, None if fscr is None else fscr.data_ptr(),
        None if sscr is None else sscr.data_ptr(), *lists, *tail)
    launch_counts["anneal_wide" if not glob else "anneal_wide_global_sparse" if sparse
                  else "anneal_wide_global"] += 1
    return out
