"""Wrapper of the CUDA parallel-tempering kernel for couplings past shared
memory (``qbmx_torch/csrc/pt_wide.cu``, K5), and the one rule that routes a
parallel-tempering call on a CUDA tensor to K3 or K5.

K5 computes what K3 (``pt_heatbath.cu``) and the plain version
(``tempering.pt_sample_batch_plain``) compute, on the structured form
(``J`` (G, n, n), ``h`` (G, B, n), ladder ``betas``/``dbeta`` (G·B, M) →
(G, B, R, n)), for the shapes K3 cannot hold: J_b past one block's shared
memory (n > 241, or M ≥ 16 at n = 241).  :func:`pt_route` is the rule:
K3 where ``pt_cuda.pt_layout`` takes the shape, K5 where
:func:`pt_wide_geometry` does, and a ``ValueError`` naming both bounds
beyond them.  :func:`pt_sample_batch` and :func:`pt_sample_groups` are the
sampler's entries: on CPU tensors they run the plain version on the
densified batch, on CUDA tensors they launch the kernel the rule picks or
raise.  K5's launches are counted here, apart from K3's.

Host variates keep K3's layout in densified slot order ``(g·B + b)·M +
m``: ``init01`` (G·B·M, R, n), ``uniforms`` (S, G·B·M, n, R), ``swap_u``
(S, G·B·M, R), so one set of arrays drives K5 and the plain version.  In
generator mode K5 draws K3's Philox streams with a wider variable block
(``sa_torch.pt_philox_variates(..., var_shift=VAR_SHIFT)`` writes them out).
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

#: launches of K5 since the last reset (one per call that reached the GPU)
launch_counts = {"pt_wide": 0}

MAX_RUNGS = 32  # a ladder a block, a warp a rung: 1024 threads (pt_wide.cu kMaxChains)
VAR_SHIFT = 10  # Philox counter word y = (rung << 10) | variable/4 (pt_wide.cu kVarShift)


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def smem_bytes(n: int, chains: int) -> int:
    """A block's shared memory at width n with ``chains`` warps: K4's layout
    (two J tiles, each warp's fields and state bytes) and each warp's two
    exchanged energies (``qbmx_pt_wide_smem``)."""
    return wide_cuda.smem_bytes(n, chains) + 8 * chains


@functools.cache
def max_n() -> int:
    """Largest n K5 takes: one rung's fields, state and energies beside two
    tiles fit one block (``qbmx_pt_wide_max_n``; K4's bound, 3368)."""
    n = 1
    while smem_bytes(n + 1, 1) <= kernel_call.SMEM_BYTES:
        n += 1
    return n


def energy_drift_bound(h: torch.Tensor, J: torch.Tensor, num_sweeps: int) -> torch.Tensor:
    """(G, B, 1, 1) float64 limit on |E − (h·s + ½ sᵀJs)| for the energies
    K5 reports after ``num_sweeps`` sweeps (``energy_out``).  K5 sums E =
    ½ Σ_i s_i (h_i + f_i) from the fields after every sweep, each field
    within ``wide_cuda.field_drift_bound`` fb_i (K5 refreshes them as K4
    does), so E is off by at most ½ Σ_i fb_i from theirs, plus the rounding
    of one float32 sum of n terms of size ≤ |h_i| + M_i (M_j =
    |h_j| + Σ_k |J_jk|), taken as √n·2^-24·Σ_i (|h_i| + M_i), a statistical
    bound as fb is."""
    n = h.shape[-1]
    fb = wide_cuda.field_drift_bound(h, J, num_sweeps)[:, :, 0]  # (G, B, n)
    scale = 2 * h.double().abs() + J.double().abs().sum(-1)[:, None, :]
    bound = 0.5 * fb.sum(-1) + math.sqrt(n) * 2.0**-24 * scale.sum(-1)
    return bound[:, :, None, None]


def max_rungs(n: int) -> int:
    """Largest ladder K5 takes at width n: at most 32 rungs, and a whole
    ladder in one block's shared memory (``qbmx_pt_wide_max_rungs``); 0 if
    none."""
    M = 0
    while M < MAX_RUNGS and smem_bytes(n, M + 1) <= kernel_call.SMEM_BYTES:
        M += 1
    return M


def bounds() -> str:
    return (f"n ≤ {max_n()}, M ≤ {MAX_RUNGS}, and a whole ladder, two J tiles beside M rows "
            f"of fields, states and energies, within {kernel_call.SMEM_BYTES:,} bytes: "
            f"M ≤ {max_rungs(717)} at n = 717, M ≤ {max_rungs(max_n())} at n = {max_n()}")


@dataclasses.dataclass(frozen=True)
class PTWideGeometry:
    ladders_per_block: int
    threads: int  # per block: a warp a rung
    smem: int  # bytes per block
    grid: tuple  # (blocks per group, groups)

    @classmethod
    def of(cls, G: int, B: int, M: int, R: int, n: int, ladders: int) -> "PTWideGeometry":
        return cls(ladders, 32 * ladders * M, smem_bytes(n, ladders * M),
                   (math.ceil(B * R / ladders), G))


def pt_wide_geometry(G: int, B: int, M: int, R: int, n: int) -> PTWideGeometry:
    """K5's launch geometry for G groups of B problems, M rungs, R reads
    (ladders a problem), width n.

    Rule: a rung a warp, a ladder's M warps in one block (its exchanges
    need only the block's barrier); a block holds L ladders of one group,
    L = ⌈G·B·R / 132⌉ (one block an SM while ladders are few), at most
    ⌊32 / M⌋ (1024 threads) and at most what shared memory holds.  The grid
    is (⌈B·R / L⌉, G).  Raises on what the kernel does not take
    (:func:`bounds`)."""
    if not (1 <= n <= max_n() and 1 <= M <= max_rungs(n)):
        raise ValueError(f"pt_wide kernel: n={n}, M={M} exceed its bound ({bounds()})")
    if G > 65535:
        raise ValueError(f"pt_wide kernel: {G} groups exceed the grid's 65535")
    fit = max(L for L in range(1, MAX_RUNGS // M + 1)
              if smem_bytes(n, L * M) <= kernel_call.SMEM_BYTES)
    L = max(1, min(math.ceil(G * B * R / kernel_call.NUM_SMS), fit))
    return PTWideGeometry.of(G, B, M, R, n, L)


def pt_route(G: int, B: int, M: int, R: int, n: int) -> str:
    """The tempering kernel a CUDA call of G groups of B problems (a dense
    batch: G = B groups of one), M rungs, R reads and width n launches:
    ``"pt_heatbath"`` (K3, on the densified batch) where ``pt_cuda.
    pt_layout`` takes the shape, ``"pt_wide"`` (K5, on the structured form)
    where :func:`pt_wide_geometry` does; raises with both bounds beyond."""
    try:
        pt_cuda.pt_layout(G * B, M, R, n)
        return "pt_heatbath"
    except ValueError as k3:
        try:
            pt_wide_geometry(G, B, M, R, n)
            return "pt_wide"
        except ValueError as k5:
            raise ValueError(f"parallel tempering on the GPU: no kernel takes n={n}, M={M} "
                             f"({G}×{B} problems, {R} reads): {k3}; {k5}") from None


def launch(J: torch.Tensor, h: torch.Tensor, betas: torch.Tensor, dbeta: torch.Tensor,
           num_reads: int, num_sweeps: int, *, generator: torch.Generator | None = None,
           host_variates=None, states_out: torch.Tensor | None = None,
           fields_out: torch.Tensor | None = None, energy_out: torch.Tensor | None = None,
           flips: torch.Tensor | None = None,
           geometry: PTWideGeometry | None = None) -> torch.Tensor:
    """Launch K5 on the structured form: ``J`` (G, n, n) symmetric
    zero-diagonal couplings, ``h`` (G, B, n) linear terms, ``betas`` and
    ``dbeta`` (G·B, M) each problem's ladder (``tempering.ladder_betas``) →
    (G, B, R, n) samples of the target rung.  Any shape within
    :func:`bounds`, so checks of the kernel may send it narrow problems
    too.

    ``states_out``, ``fields_out`` ((G·B·M, R, n) float32) and
    ``energy_out`` ((G·B·M, R)) receive each rung's final state, local
    fields and energy at slot ``p·M + m``; ``flips`` ((1,) int64, added
    to) the number of variables changed; ``geometry`` replaces
    :func:`pt_wide_geometry`'s choice.  All are for checks of the kernel;
    the sampler paths pass none."""
    from qbmx_torch._build import load_kernels

    lib = load_kernels()
    G, B, n = h.shape
    M = betas.shape[-1]
    R, S = num_reads, num_sweeps
    dev = h.device
    for t, name, shape in ((J, "J", (G, n, n)), (h, "h", (G, B, n)),
                           (betas, "betas", (G * B, M)), (dbeta, "dbeta", (G * B, M))):
        kernel_call.require(t, name, shape, dev)
    geo = geometry or pt_wide_geometry(G, B, M, R, n)
    GBM = G * B * M
    variates = kernel_call.variate_ptrs(
        host_variates, (("init01", (GBM, R, n)), ("uniforms", (S, GBM, n, R)),
                        ("swap_u", (S, GBM, R))), dev)
    outs = (kernel_call.optional_ptr(states_out, "states_out", (GBM, R, n), torch.float32, dev),
            kernel_call.optional_ptr(fields_out, "fields_out", (GBM, R, n), torch.float32, dev),
            kernel_call.optional_ptr(energy_out, "energy_out", (GBM, R), torch.float32, dev),
            kernel_call.optional_ptr(flips, "flips", (1,), torch.int64, dev))
    Jp = F.pad(J, (0, wide_cuda.row_floats(n) - n)).contiguous()  # 16-byte rows for cp.async
    seed = draw_seed(generator) if host_variates is None else 0
    out = torch.empty((G, B, R, n), dtype=torch.float32, device=dev)
    kernel_call.check_rc("pt_wide", lib.qbmx_pt_wide(
        Jp.data_ptr(), h.data_ptr(), betas.data_ptr(), dbeta.data_ptr(), *variates,
        out.data_ptr(), *outs, G, B, M, R, n, S, seed, geo.ladders_per_block,
        kernel_call.stream(dev)))
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
