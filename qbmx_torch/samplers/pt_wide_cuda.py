"""Wrapper of the CUDA parallel-tempering kernel for the calls K3 cannot
hold (``qbmx_torch/csrc/pt_wide.cu``, K5), and the one rule that routes a
parallel-tempering call on a CUDA tensor to K3 or K5.

K5 computes what K3 (``pt_heatbath.cu``) and the plain version
(``tempering.pt_sample_batch_plain``) compute, on the structured form
(``J`` (G, n, n), ``h`` (G, B, n), ladder ``betas``/``dbeta`` (G·B, M) →
(G, B, R, n)), for the shapes K3 cannot hold: J_b past one block's shared
memory (n > 241, or M ≥ 16 at n = 241), or more than 64 rungs.
:func:`pt_route` is the rule: K3 where ``pt_cuda.pt_layout`` takes the
shape, else K5, which takes every width and ladder (a grid of at most
65,535 groups).  :func:`pt_sample_batch` and :func:`pt_sample_groups` are
the sampler's entries: on CPU tensors they run the plain version on the
densified batch, on CUDA tensors they launch the kernel the rule picks.

K5 has three paths, one semantics, and the same fields bit for bit: the
sparse path holds J_g's nonzero rows (:func:`row_lists`) whole in a
block's shared memory, the dense path streams J_g in tiles beside the
rungs' fields in shared memory, and the global path keeps the rungs'
fields and states in global scratch (K4's global-field layout, with its
dense or sparse field pass by ``wide_cuda.sparse_pass``) and is launched
once a sweep, S + 1 launches a call, so that a ladder may span any number
of blocks.  :func:`pt_wide_geometry` takes the sparse path
where the row lists fit a block beside its rungs, else the dense one where
n ≤ :func:`switch_n` (1416: a block holds 20 rungs) and its ladders
fit a thread block cluster of 8 blocks (a ladder of more rungs than a
block holds spreads over a cluster), else the global path.  Each
path's launches are counted here, apart from K3's (``"pt_wide"`` dense,
``"pt_wide_sparse"``, ``"pt_wide_global"`` and, with the sparse field
pass, ``"pt_wide_global_sparse"``: one a call).

Host variates keep K3's layout in densified slot order ``(g·B + b)·M +
m``: ``init01`` (G·B·M, R, n), ``uniforms`` (S, G·B·M, n, R), ``swap_u``
(S, G·B·M, R), so one set of arrays drives K5 and the plain version.  In
generator mode K5 draws K3's Philox streams with a wider variable block
(``sa_torch.pt_philox_variates(..., var_shift=var_shift(n))`` writes them
out).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F

from qbmx_torch.core.qubo import densify_groups, split_qubo
from qbmx_torch.core.rng import draw_seed
from qbmx_torch.samplers import kernel_call, pt_cuda, tempering, wide_cuda
from qbmx_torch.utils.spans import span, spanned

#: launches of K5 since the last reset (one per call that reached the GPU), by path
launch_counts = {"pt_wide": 0, "pt_wide_sparse": 0, "pt_wide_global": 0,
                 "pt_wide_global_sparse": 0}

DENSE, SPARSE, GLOBAL = "dense", "sparse", "global"
MAX_WARPS = 32  # rungs a block, a warp each: 1024 threads (pt_wide.cu kMaxWarps)
MAX_CLUSTER = 8  # blocks a ladder: the portable thread block cluster size
VAR_SHIFT = 10  # Philox counter word y = (rung << 10) | variable/4 (pt_wide.cu kVarShift)
SWITCH_RUNGS = 20  # the fewest rungs a dense-path block holds for the rule to give it the call


def var_shift(n: int) -> int:
    """Bits of K5's Philox variable block at width n: :data:`VAR_SHIFT`
    while the ⌈n/4⌉ blocks stay below the swap draws' slot 2^10 − 1 (n ≤
    4092, every shape of the shared paths), one more each time they reach
    it (the global path's; 11 up to n = 8188)."""
    s = VAR_SHIFT
    while -(-n // 4) > (1 << s) - 1:
        s += 1
    return s


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def smem_bytes(n: int, warps: int) -> int:
    """A dense-path block's shared memory at width n with ``warps`` warps:
    K4's layout (two J tiles, each warp's fields and state bytes) and each
    warp's two exchanged energies (``qbmx_pt_wide_smem``)."""
    return wide_cuda.smem_bytes(n, warps) + 8 * warps


def offsets_len(n: int) -> int:
    """Ints of a group's row offsets: n + 1 rounded up to 4 (16-byte copies)."""
    return -(-(n + 1) // 4) * 4


def sparse_smem_bytes(n: int, warps: int, nnz_pad: int) -> int:
    """A sparse-path block's shared memory: the group's row lists (nnz_pad
    fp32 values and 16-bit columns, the offsets), then the rows of
    ``warps`` warps as on the dense path (``qbmx_pt_wide_sparse_smem``)."""
    return 6 * nnz_pad + 4 * offsets_len(n) + smem_bytes(n, warps) - smem_bytes(n, 0)


def padded(nnz: int) -> int:
    """Row-list entries a group holds for ``nnz`` nonzeros: a multiple of 8
    (16-byte aligned groups), at least 8."""
    return max(8, -(-nnz // 8) * 8)


@functools.cache
def max_n() -> int:
    """Largest n of K5's shared paths: one rung's fields, state and
    energies beside two tiles fit one block (``qbmx_pt_wide_max_n``; K4's
    shared layout's bound, 3368).  The global path takes any n."""
    n = 1
    while smem_bytes(n + 1, 1) <= kernel_call.SMEM_BYTES:
        n += 1
    return n


@functools.cache
def switch_n() -> int:
    """Widest n the rule gives the dense path: where a block still holds
    :data:`SWITCH_RUNGS` rungs (1416).  Measured on an H100 with both paths
    forced at M = 8 on 32,000 rungs (``chip_smoke.py`` phase 10's turns,
    after the global path's windows and sparse pass): the dense path is
    9-12% faster up to n = 1216 (25 rungs a block), 1-2% at 1280 and 1408
    (23, 20), 13% slower at 1536 (17); K4's layouts tie earlier
    (``wide_cuda.switch_n``, 1056)."""
    n = 1
    while smem_bytes(n + 1, SWITCH_RUNGS) <= kernel_call.SMEM_BYTES:
        n += 1
    return n


def block_rungs(n: int, nnz_pad: int | None = None) -> int:
    """Rungs a block holds at width n, a warp each: at most 32, and what
    shared memory holds beside two J tiles (the dense path) or beside row
    lists of ``nnz_pad`` entries (the sparse path); 0 if none
    (``qbmx_pt_wide_block_rungs``, ``qbmx_pt_wide_sparse_block_rungs``)."""
    size = (lambda W: smem_bytes(n, W)) if nnz_pad is None else \
        (lambda W: sparse_smem_bytes(n, W, nnz_pad))
    W = 0
    while W < MAX_WARPS and size(W + 1) <= kernel_call.SMEM_BYTES:
        W += 1
    return W


def max_rungs(n: int) -> int:
    """Largest ladder of K5's shared paths at width n: the dense path's
    rungs a block over a cluster of 8 blocks (``qbmx_pt_wide_max_rungs``:
    256 up to n ≈ 2600, 8 at n = 3368; 0 past n = 3368).  Longer ladders
    and wider problems take the global path."""
    return block_rungs(n) * MAX_CLUSTER if n <= max_n() else 0


def global_warps(G: int, B: int, M: int, R: int) -> int:
    """States (a warp each) a block of the global path holds: ⌈G·B·R·M /
    132⌉ (one block per SM when the states allow), at most 32."""
    return max(1, min(math.ceil(G * B * R * M / kernel_call.NUM_SMS), MAX_WARPS))


def energy_drift_bound(h: torch.Tensor, J: torch.Tensor, num_sweeps: int) -> torch.Tensor:
    """(G, B, 1, 1) float64 limit on |E − (h·s + ½ sᵀJs)| for the energies
    K5 reports after ``num_sweeps`` sweeps (``energy_out``).  K5 sums E =
    ½ Σ_i s_i (h_i + f_i) from the fields after every sweep, each field
    within ``wide_cuda.field_drift_bound`` fb_i (K5 refreshes them as K4
    does, on either path), so E is off by at most ½ Σ_i fb_i from theirs,
    plus the rounding of one float32 sum of n terms of size ≤ |h_i| + M_i
    (M_j = |h_j| + Σ_k |J_jk|), taken as √n·2^-24·Σ_i (|h_i| + M_i), a
    statistical bound as fb is."""
    n = h.shape[-1]
    fb = wide_cuda.field_drift_bound(h, J, num_sweeps)[:, :, 0]  # (G, B, n)
    scale = 2 * h.double().abs() + J.double().abs().sum(-1)[:, None, :]
    bound = 0.5 * fb.sum(-1) + math.sqrt(n) * 2.0**-24 * scale.sum(-1)
    return bound[:, :, None, None]


@dataclasses.dataclass(frozen=True)
class RowLists:
    """J_g's nonzero rows as the sparse path reads them: row i of group g
    holds entries ``offsets[g, i]`` .. ``offsets[g, i+1]-1`` of ``vals`` and
    ``cols``, columns in increasing order; each group's entries padded with
    zeros to ``nnz_pad``, a multiple of 8, so every group starts 16-byte
    aligned."""

    vals: torch.Tensor  # (G, nnz_pad) float32: the nonzero J_ij
    cols: torch.Tensor  # (G, nnz_pad) int16: their columns j
    offsets: torch.Tensor  # (G, offsets_len(n)) int32, past n + 1 the group's count
    nnz: tuple  # nonzeros a group

    @property
    def nnz_pad(self) -> int:
        return self.vals.shape[1]


def row_nnz(J: torch.Tensor) -> torch.Tensor:
    """(G, n) int32: the nonzeros of each row of J (G, n, n)."""
    return (J != 0).sum(-1, dtype=torch.int32)


def group_nnz(counts: torch.Tensor) -> tuple:
    """The nonzeros of each group from :func:`row_nnz`'s counts, fetched to
    the host (the largest group sizes the lists)."""
    with span("sync.rows_nnz"):
        return tuple(counts.sum(-1).tolist())


@spanned("row_lists")
def row_lists(J: torch.Tensor, counts: torch.Tensor | None = None,
              nnz: tuple | None = None) -> RowLists:
    """J (G, n, n)'s nonzero rows, on J's device, by plain tensor code;
    ``counts`` (:func:`row_nnz`) and ``nnz`` (:func:`group_nnz`) where the
    caller has them.  Its host syncs (on a CUDA ``J``) are the ``sync.rows_*``
    spans inside the ``row_lists`` span."""
    G, n, _ = J.shape
    mask = J != 0
    counts = row_nnz(J) if counts is None else counts  # (G, n)
    nnz = group_nnz(counts) if nnz is None else nnz
    ends = counts.cumsum(-1, dtype=torch.int32)
    offsets = torch.empty((G, offsets_len(n)), dtype=torch.int32, device=J.device)
    offsets[:, 0] = 0
    offsets[:, 1:n + 1] = ends
    offsets[:, n + 1:] = ends[:, -1:]
    nnz_pad = padded(max(nnz))
    # the nonzeros as (g, i, j) in lexicographic order: row by row, columns
    # increasing; a group's k-th goes to column k of its padded list
    with span("sync.rows_nonzero"):
        idx = mask.nonzero()
    g = idx[:, 0]
    with span("sync.rows_sizes"):
        sizes = torch.as_tensor(nnz, dtype=torch.int64, device=J.device)
    k = torch.arange(idx.shape[0], device=J.device) - (sizes.cumsum(0) - sizes)[g]
    vals = torch.zeros((G, nnz_pad), dtype=torch.float32, device=J.device)
    cols = torch.zeros((G, nnz_pad), dtype=torch.int16, device=J.device)
    with span("sync.rows_values"):  # a boolean mask's index counts its entries
        vals[g, k] = J.to(torch.float32)[mask]
    cols[g, k] = idx[:, 2].to(torch.int16)
    return RowLists(vals, cols, offsets, nnz)


@dataclasses.dataclass(frozen=True)
class PTWideGeometry:
    path: str  # DENSE (J_g in tiles), SPARSE (its row lists in shared memory) or GLOBAL
    ladders_per_block: int  # 0 on the global path: a block holds states of any ladders
    cluster: int  # blocks a ladder (a thread block cluster); 1: whole ladders a block
    warps: int  # per block: a warp a rung
    threads: int
    smem: int  # bytes per block
    grid: tuple  # (blocks per group, groups)
    nnz_pad: int = 0  # the sparse path's row-list entries a group

    @classmethod
    def of(cls, G: int, B: int, M: int, R: int, n: int, ladders: int, cluster: int = 1,
           nnz_pad: int | None = None) -> "PTWideGeometry":
        """``ladders`` whole ladders a block (``cluster`` 1), or one ladder
        over ``cluster`` blocks of ⌈M / cluster⌉ warps; the sparse path
        with row lists of ``nnz_pad`` entries, else the dense one."""
        if cluster == 1:
            warps, grid = ladders * M, (math.ceil(B * R / ladders), G)
        else:
            if ladders != 1:
                raise ValueError("pt_wide kernel: a ladder over a cluster is one a cluster")
            warps, grid = math.ceil(M / cluster), (B * R * cluster, G)
        if nnz_pad is None:
            return cls(DENSE, ladders, cluster, warps, 32 * warps, smem_bytes(n, warps), grid)
        return cls(SPARSE, ladders, cluster, warps, 32 * warps,
                   sparse_smem_bytes(n, warps, nnz_pad), grid, nnz_pad)

    @classmethod
    def global_path(cls, G: int, B: int, M: int, R: int, n: int, warps: int) -> "PTWideGeometry":
        """The global path with ``warps`` states a block (any ladders)."""
        return cls(GLOBAL, 0, 1, warps, 32 * warps, wide_cuda.global_smem_bytes(warps),
                   (math.ceil(B * R * M / warps), G))


def shared_geometry(G: int, B: int, M: int, R: int, n: int,
                    nnz_pad: int | None = None) -> PTWideGeometry:
    """The geometry of K5's shared paths: the sparse path where J_g's row
    lists of ``nnz_pad`` entries a group fit a block beside at least ⌈M /
    8⌉ rungs (every ladder within a cluster), else the dense path.  A rung
    is a warp; where a block holds W ≥ M rungs, whole ladders of one group
    a block (their exchanges need only the block's barrier), L = ⌈G·B·R /
    132⌉ of them (one block an SM while ladders are few), at most ⌊W / M⌋,
    on a grid of (⌈B·R / L⌉, G); else a ladder over a cluster of K = ⌈M /
    W⌉ ≤ 8 blocks of ⌈M / K⌉ rungs, on a grid of (B·R·K, G).  Raises where
    n > 3368 or M > :func:`max_rungs`."""
    if not (n <= max_n() and M <= max_rungs(n)):
        raise ValueError(f"pt_wide kernel: n={n}, M={M} exceed the shared paths' bounds "
                         f"(n ≤ {max_n()}, M ≤ {max_rungs(min(n, max_n()))})")
    if nnz_pad is not None and M > block_rungs(n, nnz_pad) * MAX_CLUSTER:
        nnz_pad = None  # the row lists leave too little room: the dense path
    W = block_rungs(n, nnz_pad)
    if M > W:
        return PTWideGeometry.of(G, B, M, R, n, 1, math.ceil(M / W), nnz_pad)
    L = max(1, min(math.ceil(G * B * R / kernel_call.NUM_SMS), W // M))
    return PTWideGeometry.of(G, B, M, R, n, L, 1, nnz_pad)


def pt_wide_geometry(G: int, B: int, M: int, R: int, n: int,
                     nnz_pad: int | None = None) -> PTWideGeometry:
    """K5's launch geometry for G groups of B problems, M rungs, R reads
    (ladders a problem), width n, and J_g's row lists of ``nnz_pad``
    entries a group (None: not built).

    Rule: :func:`shared_geometry` where n ≤ 3368 and M ≤ :func:`max_rungs`,
    if it takes the sparse path or n ≤ :func:`switch_n` (1416, where a
    block holds 20 rungs); else the global path, :func:`global_warps`
    states of one group a block, on a grid of (⌈B·R·M / W⌉, G), launched
    S + 1 times, as fast or faster past it (:func:`switch_n`).  Raises only
    on an empty shape or more than 65,535 groups."""
    if n < 1 or M < 1:
        raise ValueError(f"pt_wide kernel: n={n}, M={M}: no problem to sample")
    if G > 65535:
        raise ValueError(f"pt_wide kernel: {G} groups exceed the grid's 65535")
    if n <= max_n() and M <= max_rungs(n):
        geo = shared_geometry(G, B, M, R, n, nnz_pad)
        if geo.path == SPARSE or n <= switch_n():
            return geo
    return PTWideGeometry.global_path(G, B, M, R, n, global_warps(G, B, M, R))


def pt_route(G: int, B: int, M: int, R: int, n: int) -> str:
    """The tempering kernel a CUDA call of G groups of B problems (a dense
    batch: G = B groups of one), M rungs, R reads and width n launches:
    ``"pt_heatbath"`` (K3, on the densified batch) where ``pt_cuda.
    pt_layout`` takes the shape, else ``"pt_wide"`` (K5, on the structured
    form, the path :func:`pt_wide_geometry` picks), which takes every width
    and ladder; raises only where that does (more than 65,535 groups)."""
    try:
        pt_cuda.pt_layout(G * B, M, R, n)
        return "pt_heatbath"
    except ValueError:
        pt_wide_geometry(G, B, M, R, n)
        return "pt_wide"


def launch(J: torch.Tensor, h: torch.Tensor, betas: torch.Tensor, dbeta: torch.Tensor,
           num_reads: int, num_sweeps: int, *, generator: torch.Generator | None = None,
           host_variates=None, states_out: torch.Tensor | None = None,
           fields_out: torch.Tensor | None = None, energy_out: torch.Tensor | None = None,
           flips: torch.Tensor | None = None, geometry: PTWideGeometry | None = None,
           path: str | None = None, field_pass: str | None = None) -> torch.Tensor:
    """Launch K5 on the structured form: ``J`` (G, n, n) symmetric
    zero-diagonal couplings, ``h`` (G, B, n) linear terms, ``betas`` and
    ``dbeta`` (G·B, M) each problem's ladder (``tempering.ladder_betas``) →
    (G, B, R, n) samples of the target rung.  Any width and ladder, so
    checks of the kernel may send it narrow problems too.  The path is
    :func:`pt_wide_geometry`'s choice on J's row lists.

    ``states_out``, ``fields_out`` ((G·B·M, R, n) float32) and
    ``energy_out`` ((G·B·M, R)) receive each rung's final state, local
    fields and energy at slot ``p·M + m``; ``flips`` ((2,) int64, added
    to) the number of variables changed and the nonzeros of their rows;
    ``path`` (:data:`DENSE`, :data:`SPARSE` or :data:`GLOBAL`) forces a
    path, ``geometry`` replaces the rule's whole choice, and ``field_pass``
    (``"dense"`` or ``"sparse"``) the global path's
    ``wide_cuda.sparse_pass``.  All are for checks of the kernel; the
    sampler paths pass none."""
    from qbmx_torch._build import load_kernels

    lib = load_kernels()
    G, B, n = h.shape
    M = betas.shape[-1]
    R, S = num_reads, num_sweeps
    dev = h.device
    for t, name, shape in ((J, "J", (G, n, n)), (h, "h", (G, B, n)),
                           (betas, "betas", (G * B, M)), (dbeta, "dbeta", (G * B, M))):
        kernel_call.require(t, name, shape, dev)
    if path not in (None, DENSE, SPARSE, GLOBAL):
        raise ValueError(f"pt_wide kernel: unknown path {path!r}")
    if field_pass not in (None, "dense", "sparse"):
        raise ValueError(f"pt_wide kernel: unknown field pass {field_pass!r}")
    if path == GLOBAL and geometry is None:
        geometry = PTWideGeometry.global_path(G, B, M, R, n, global_warps(G, B, M, R))
    if path == DENSE and geometry is None:
        geometry = shared_geometry(G, B, M, R, n)
    sparse = path in (None, SPARSE) and n <= max_n() and M <= max_rungs(n) and (
        geometry is None or geometry.path == SPARSE)  # the sparse path may take the call
    counts = row_nnz(J) if sparse or flips is not None else None
    nnz = group_nnz(counts) if sparse else None
    geo = geometry or pt_wide_geometry(G, B, M, R, n, nnz and padded(max(nnz)))
    if path is not None and geo.path != path:
        raise ValueError(f"pt_wide kernel: the {path} path does not take n={n}, M={M} "
                         f"({geo.path} path chosen)")
    if field_pass is not None and geo.path != GLOBAL:
        raise ValueError("pt_wide kernel: a field pass is the global path's")
    glob_sparse = False
    if geo.path == GLOBAL:
        counts = row_nnz(J) if counts is None else counts
        glob_sparse = (wide_cuda.sparse_pass(counts, n) if field_pass is None
                       else field_pass == "sparse")
        if glob_sparse and n > wide_cuda.MAX_SPARSE_N:
            raise ValueError("pt_wide kernel: the sparse pass takes "
                             f"n ≤ {wide_cuda.MAX_SPARSE_N}")
    rows = row_lists(J, counts, nnz) if geo.path == SPARSE or glob_sparse else None
    if geo.path == SPARSE and geo.nnz_pad != rows.nnz_pad:
        raise ValueError(f"pt_wide kernel: geometry for {geo.nnz_pad} entries a group, "
                         f"J's row lists hold {rows.nnz_pad}")
    GBM = G * B * M
    variates = kernel_call.variate_ptrs(
        host_variates, (("init01", (GBM, R, n)), ("uniforms", (S, GBM, n, R)),
                        ("swap_u", (S, GBM, R))), dev)
    outs = (kernel_call.optional_ptr(states_out, "states_out", (GBM, R, n), torch.float32, dev),
            kernel_call.optional_ptr(fields_out, "fields_out", (GBM, R, n), torch.float32, dev),
            kernel_call.optional_ptr(energy_out, "energy_out", (GBM, R), torch.float32, dev),
            kernel_call.optional_ptr(flips, "flips", (2,), torch.int64, dev))
    seed = draw_seed(generator) if host_variates is None else 0
    out = torch.empty((G, B, R, n), dtype=torch.float32, device=dev)
    tail = (h.data_ptr(), betas.data_ptr(), dbeta.data_ptr(), *variates, out.data_ptr(), *outs,
            G, B, M, R, n, S, seed)
    if geo.path == GLOBAL:
        jrow = wide_cuda.global_row_floats(n)
        states = G * B * R * M
        Jp = F.pad(J, (0, jrow - n)).contiguous()  # 32-byte rows: the diagonal blocks' copies
        fields = torch.zeros((states, jrow), dtype=torch.float32, device=dev)
        state = torch.zeros((states, jrow), dtype=torch.uint8, device=dev)
        energies = torch.empty((2, states), dtype=torch.float32, device=dev)
        rho = torch.empty((states,), dtype=torch.int32, device=dev)
        lists = (None, None, None, 0) if rows is None else (
            rows.vals.data_ptr(), rows.cols.data_ptr(), rows.offsets.data_ptr(), rows.nnz_pad)
        kernel_call.call("pt_wide_global", lib.qbmx_pt_wide_global,
            Jp.data_ptr(), None if flips is None else counts.data_ptr(), *tail[:-7],
            fields.data_ptr(), state.data_ptr(), energies.data_ptr(), rho.data_ptr(), *lists,
            *tail[-7:], geo.warps, var_shift(n), kernel_call.stream(dev))
        launch_counts["pt_wide_global_sparse" if rows is not None else "pt_wide_global"] += 1
    elif geo.path == SPARSE:
        kernel_call.call("pt_wide_sparse", lib.qbmx_pt_wide_sparse,
            rows.vals.data_ptr(), rows.cols.data_ptr(), rows.offsets.data_ptr(), *tail,
            geo.nnz_pad, geo.ladders_per_block, geo.cluster, kernel_call.stream(dev))
        launch_counts["pt_wide_sparse"] += 1
    else:
        Jp = F.pad(J, (0, wide_cuda.row_floats(n) - n)).contiguous()  # 16-byte rows for cp.async
        kernel_call.call("pt_wide", lib.qbmx_pt_wide,
            Jp.data_ptr(), None if flips is None else counts.data_ptr(), *tail,
            geo.ladders_per_block, geo.cluster, kernel_call.stream(dev))
        launch_counts["pt_wide"] += 1
    return out


def structured_form(Q_shared: torch.Tensor, h_extra: torch.Tensor, num_replicas: int,
                    beta_target: float = 1.0):
    """``(J, h, betas, dbeta)`` as K5 takes them from ``Q_shared`` (G, n, n)
    and ``h_extra`` (G, B, n).  The ladders are ``tempering.ladder_betas``
    of the densified batch, so they equal the plain version's bit for bit
    (the densified batch lives for this computation only).  The same range
    taken from ``J`` and ``h`` (``qubo.beta_range_from_parts``) is equal on
    the CPU, but not on the card: there a row sum of |J| rounds by the
    row's address, which differs between ``J`` and the densified batch at
    odd n, and so does the last bit of some ladders."""
    Q = Q_shared.to(torch.float32)
    hs, J = split_qubo(Q)
    h = (hs[:, None, :] + h_extra.to(torch.float32)).contiguous()
    betas, dbeta = tempering.ladder_betas(densify_groups(Q, h_extra), num_replicas, beta_target)
    return J.contiguous(), h, betas, dbeta


def pt_sample_groups(Q_shared: torch.Tensor, h_extra: torch.Tensor, num_reads: int,
                     num_sweeps: int = 64, *, num_replicas: int = 8, beta_target: float = 1.0,
                     generator: torch.Generator | None = None,
                     host_variates=None) -> torch.Tensor:
    """Structured parallel tempering, ``Q_shared`` (G, n, n) + ``h_extra``
    (G, B, n) → (G, B, R, n) samples of the target rung: the plain version
    on the densified batch for CPU tensors; on CUDA tensors K3 on the
    densified batch or K5 on the structured form, by :func:`pt_route`."""
    G, B, n = h_extra.shape
    M, R, S = num_replicas, num_reads, num_sweeps
    kw = dict(num_replicas=M, beta_target=beta_target, generator=generator,
              host_variates=host_variates)
    if Q_shared.device.type != "cuda" or pt_route(G, B, M, R, n) == "pt_heatbath":
        # pt_cuda's wrapper: the plain version on CPU tensors, K3 on CUDA ones
        flat = pt_cuda.pt_sample_batch_cuda(densify_groups(Q_shared, h_extra), R, S, **kw)
        return flat.reshape(G, B, R, n)
    return launch(*structured_form(Q_shared, h_extra, M, beta_target), R, S,
                  generator=generator, host_variates=host_variates)


def pt_sample_batch(Q: torch.Tensor, num_reads: int, num_sweeps: int = 64, *,
                    num_replicas: int = 8, beta_target: float = 1.0,
                    generator: torch.Generator | None = None,
                    host_variates=None) -> torch.Tensor:
    """Dense parallel tempering, ``Q`` (B, n, n) → (B, R, n): the plain
    version for CPU tensors; on CUDA tensors K3, or K5 with G = B groups of
    one problem, by :func:`pt_route`."""
    B, n = Q.shape[0], Q.shape[-1]
    kw = dict(num_replicas=num_replicas, beta_target=beta_target, generator=generator,
              host_variates=host_variates)
    if Q.device.type != "cuda" or pt_route(B, 1, num_replicas, num_reads, n) == "pt_heatbath":
        return pt_cuda.pt_sample_batch_cuda(Q, num_reads, num_sweeps, **kw)
    return pt_sample_groups(Q, Q.new_zeros((B, 1, n)), num_reads, num_sweeps, **kw)[:, 0]
