"""Time the port's wide kernels against their sources at earlier commits,
on one GPU, in one process, in turns (old, new, new, old): K5
(``pt_wide.cu``) and K4 (``anneal_wide.cu``) against commit 492df98 (K5
streaming J_g in tiles, whole ladders a block; K4 before its per-row work
counter), and K4's and K5's global-field layouts against commit 210c6d7
(before their windows and sparse field pass); K4's shared layout's two
paths against each other; and the layouts of K1, K2 and K3 against each
other.

    mkdir -p build/old && git archive 492df98 qbmx_torch/csrc | tar -x -C build/old
    python -m qbmx_torch.cli.compare_kernels --old build/old/qbmx_torch/csrc --parts k5 k4
    mkdir -p build/old/210c6d7 && git archive 210c6d7 qbmx_torch/csrc | tar -x -C build/old/210c6d7
    python -m qbmx_torch.cli.compare_kernels --parent build/old/210c6d7/qbmx_torch/csrc \
        --parts split global density split_new
    python -m qbmx_torch.cli.compare_kernels --parts sparse_shared sparse_density sparse_split
    python -m qbmx_torch.cli.compare_kernels --parts pt_layouts --runs 3
    mkdir -p build/old/2871102 && git archive 2871102 qbmx_torch/csrc | tar -x -C build/old/2871102
    python -m qbmx_torch.cli.compare_kernels --pt_parent build/old/2871102/qbmx_torch/csrc \
        --parts pt_parent

Each old library is declared with its commit's C interface, so the tool
compares against those commits' sources only; they are built with the
same ``nvcc`` flags into ``build/kernels_*/``.  Parts (``--parts``, all by
default):

* ``k5``: old against new in Philox mode at the CDQBM (a) PT call (G=2,
  B=20, M=8, R=100, n=717) on the step's own QUBOs (``CDQBM.step_qubos``
  on random images: J_g 98% zeros), at S=10 and S=1000: the new K5 as the
  rule picks it (the sparse path) and with the dense path forced; then the
  sparse path at 4, 2 and 1 ladders a block (one block of 32, 16 or two
  blocks of 8 warps an SM), in turns against the rule's 4.  Each new
  launch also counts its flips once, for the bound
  (``qbmx_torch.utils.roofline``);
* ``k4``: old against new, K4 Metropolis and pair at the CDQBM (a) call
  (G=2, B=20, n=717, R=100, S=1000) on a random QUBO;
* ``layouts``: K1's and K2's layouts (a thread a chain, 4, 8 or 16
  lanes a chain, a warp a chain), each forced, at every n of
  ``LAYOUT_NS`` and chain count of ``LAYOUT_CHAINS`` (S = ``LAYOUT_S``,
  Philox mode), in turns (a rotation through the layouts and back), from a
  build of K1 and K2 whose THREAD layout reaches n = ``THREAD_WIDE``
  (``-DQBMX_THREAD_MAX_N``, into ``build/kernels_thread_wide/``): the
  measurements ``kernel_call.chain_layout``'s boundaries rest on;
* ``pt_layouts``: K3's layouts (a rung a thread, on 4, 8 or 16 lanes, a
  rung a warp), each forced, at every n of ``PT_LAYOUT_NS`` and call of
  ``PT_LAYOUT_CALLS`` (M = 8 at 4,800 to 960,000 rungs, and M = 4 and 16;
  S = ``LAYOUT_S``, Philox mode), in turns: the measurements
  ``pt_cuda.pt_layout``'s boundaries rest on, the fastest layout and the
  rule's pick at each;
* ``pt_parent``: K3 a rung a thread at n ≤ 8 from commit 2871102's
  ``pt_heatbath.cu`` (before its layouts past n = 8) against this tree's,
  in turns, at the flagship PT call, the flat CLI defaults', the search's
  PT h5 call and the flagship sweep's (``PT_PARENT_CALLS``), with both
  samples compared bit for bit on one seed;
* ``k4_agreement``: K4's agreement with plain at ``tests/test_torch_cuda.py``'s
  deep shape (n = 301, S = 70, heat-bath at beta 1.5; G=1, B=4, R=500,
  three seeds), this K4 against this K4 built with
  ``-DQBMX_K4_REFRESH_PERIOD=1`` (into ``build/kernels_refresh1/``: every
  field recomputed just before its decision);
* ``split``: 210c6d7's global layouts (K4 Metropolis and pair, K5 M=8) at
  both H=3400 step calls (``flat_step_qubos``: restricted, and ``-r False``),
  each timed whole, without its field pass and with its loads alone
  (``build_split``), and its chain-tiles with a change counted;
* ``global``: 210c6d7's global layouts against this tree's, in turns, at
  both H=3400 calls (the new ones on the pass the density rule picks and
  on the other, forced) and at n = 4096 and 8192 on 256 chains;
* ``density``: this tree's sparse field pass against its dense one at n =
  3401 across densities of J_g (``DENSITIES``), in turns: the tie that
  ``wide_cuda.SPARSE_DENSITY`` rests on;
* ``split_new``: ``split`` for this tree's global layouts, through the
  wrappers (on the pass the density rule picks);
* ``sparse_shared``: K4's shared layout, its sparse path (J_g's row lists in
  shared memory, ``anneal_wide_sparse.cu``) against its dense path (J_g in
  tiles), each forced, in turns (dense, sparse, sparse, dense), Metropolis
  and pair at S=1000 on the main paths' own QUBOs: the CDQBM (a) call (G=2
  B=20 R=100 n=717), its 10-seed sweep's call (G=20: seeds 0..9's step
  QUBOs) and the restricted flat model's calls, ``qbm_main -hn 300 -r
  True`` at the CLI's defaults (G=2 B=73 R=100 n=301), at ``-b 20`` and at
  ``-hn 700``; each call's changes and the nonzeros of their rows counted
  once, for the bound;
* ``sparse_density``: the same two paths at n = 301, 384, 512 and 717 on
  4,000, 14,600 and 40,000 chains (S = 100) across J_g's shares of nonzeros
  (``SHARED_DENSITIES``, where the row lists fit beside the rule's chains):
  the tie ``wide_cuda.SHARED_SPARSE_DENSITY`` rests on;
* ``sparse_split``: the sparse path's time by part at the ``sparse_shared``
  calls, from a build with ``-DQBMX_K4S_CLOCKS`` (into
  ``build/kernels_k4s_clocks/``): each chain's clock64 cycles in its
  draws, refreshes, decisions and changes, their shares, and those shares
  of the main build's time.

Each turn is the median of ``--runs`` CUDA-event timings after a warm-up.
Prints one line per measurement, the ``nvidia-smi`` name and power limit,
and last one JSON object with every number.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import statistics
import subprocess
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from qbmx_torch import _build
from qbmx_torch.core.qubo import random_qubo_batch, split_qubo
from qbmx_torch.models.cdqbm import cdqbm_a_qubos
from qbmx_torch.models.dqbm import DiscQBM
from qbmx_torch.core.rng import draw_seed
from qbmx_torch.samplers import (gibbs, kernel_call, pt_cuda, pt_wide_cuda, sa_torch, tempering,
                                 wide_cuda)
from qbmx_torch.utils.roofline import anneal_bound, heatbath_units

PARTS = ("k5", "k4", "layouts", "pt_layouts", "pt_parent", "k4_agreement", "split", "global",
         "density", "split_new", "sparse_shared", "sparse_density", "sparse_split")
OLD_PARTS = ("k5", "k4", "k4_agreement")  # the parts that build 492df98's sources (--old)
PARENT = "210c6d7"  # the global layouts before their redesign
PARENT_PARTS = ("split", "global")  # the parts that build its sources (--parent)
PT_PARENT = "2871102"  # K3 before its layouts past n = 8 (--pt_parent, part pt_parent)
# the pt_parent part's calls, K3 a rung a thread at n ≤ 8 in both: label -> (B, M, R, n, S)
PT_PARENT_CALLS = {
    "the flagship PT call": (120, 8, 1000, 6, 1000),
    "the flat CLI defaults' PT call": (146, 8, 100, 3, 1000),
    "the search's PT h5 call": (400, 8, 1000, 6, 128),
    "the flagship PT sweep call": (1200, 8, 1000, 6, 1000),
}
# the global part's shapes past the H=3400 calls: label -> (G, B, R, M, n, S), 256 chains
GLOBAL_WIDE = {"n=4096": (1, 2, 128, 16, 4096, 5), "n=8192": (1, 2, 128, 16, 8192, 5)}
DENSITIES = (0.005, 0.01, 0.02, 0.04, 0.08)  # the density part's J_g, at n = 3401
K5_CALL = dict(G=2, B=20, M=8, R=100, n=717)  # the CDQBM (a) PT call
# the sparse_density part's J_g shares, widths and chain counts (G, B, R)
SHARED_DENSITIES = (0.005, 0.01, 0.02, 0.04, 0.08)
SHARED_DENSITY_NS = (301, 384, 512, 717)
SHARED_DENSITY_CHAINS = {4_000: (2, 20, 100), 14_600: (2, 73, 100), 40_000: (20, 20, 100)}
SHARED_DENSITY_S = 100
CLOCK_PARTS = ("draws", "refresh", "decisions", "changes")  # anneal_wide_sparse.cu's Part
K4_SHAPES = {  # label: (rule, G, B, n, R, S)
    "K4 Metropolis CDQBM (a) G=2 B=20 n=717 R=100 S=1000": (0, 2, 20, 717, 100, 1000),
    "K4 pair CDQBM (a) G=2 B=20 n=717 R=100 S=1000": (2, 2, 20, 717, 100, 1000),
}
LAYOUT_NS = (3, 6, 8, 9, 10, 12, 16, 24, 32, 41, 64)  # the layouts part's widths
LAYOUT_CHAINS = {  # chains: (G, B, R) of the layouts part
    600: (2, 3, 100),  # the CDQBM (b) call
    2_000: (2, 10, 100),
    4_224: (1, 44, 96),  # 32 warps a SM at a warp a chain
    6_000: (20, 3, 100),  # the 10-seed CDQBM (b) sweep's call
    12_000: (2, 60, 100),  # the warm start's call
    19_200: (2, 96, 100),  # the h8 band's call
    120_000: (2, 60, 1000),  # the flagship call
    400_000: (20, 20, 1000),  # the search's call
}
LAYOUT_S = 100
THREAD_WIDE = 48  # the layouts part's THREAD bound
PT_LAYOUT_NS = (3, 6, 8, 9, 11, 12, 16, 24, 32, 41, 64)  # the pt_layouts part's widths
PT_LAYOUT_CALLS = {  # (M, rungs): (B, R) of the pt_layouts part
    (8, 4_800): (6, 100),  # the CDQBM (b) PT call
    (8, 16_000): (20, 100),  # qm.main's PT call
    (8, 48_000): (60, 100),  # the CDQBM (b) PT sweep's call
    (8, 153_600): (1200, 16),  # a 10-seed flat sweep's call at the bands' reads
    (8, 960_000): (120, 1000),  # the flat PT h8 call at the flagship's reads
    (4, 16_000): (40, 100), (4, 48_000): (120, 100),
    (16, 16_000): (10, 100), (16, 48_000): (30, 100),
}
K4_AGREE = dict(G=1, B=4, n=301, R=500, S=70, beta=1.5, seeds=(0, 1, 2))
RULES = {"Metropolis": 0, "single": 1, "pair": 2, "quad": 4}


def build(name: str, sources: list[Path],
          defines: tuple[str, ...] = ()) -> tuple[list[list[str]], list[str]]:
    """The ``nvcc`` commands that build ``sources`` into ``build/<name>/lib<name>.so``:
    one compile a source, then the link."""
    out = _build.BUILD_DIR.parent / name
    out.mkdir(parents=True, exist_ok=True)
    nvcc, objs = _build._nvcc(), [out / f"{src.stem}.o" for src in sources]
    compile_ = [[nvcc, *_build.NVCC_FLAGS, *defines, "-c", "-o", str(o), str(src)]
                for src, o in zip(sources, objs)]
    return compile_, [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(out / f"lib{name}.so"),
                      *map(str, objs)]


def build_libs(old_csrc: Path) -> tuple[ctypes.CDLL, ctypes.CDLL]:
    """The old K4 and K5, and this K4 refreshing its fields every sweep."""
    jobs = [build("kernels_old", [old_csrc / "anneal_wide.cu", old_csrc / "pt_wide.cu"]),
            build("kernels_refresh1", [_build.CSRC / "anneal_wide.cu"],
                  ("-DQBMX_K4_REFRESH_PERIOD=1",))]
    _build._run_all([c for compile_, _ in jobs for c in compile_])
    _build._run_all([link for _, link in jobs])
    old, refresh1 = (ctypes.CDLL(link[link.index("-o") + 1]) for _, link in jobs)
    p, i, f, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_ulonglong
    old.qbmx_anneal_wide.argtypes = [p] * 9 + [i] * 5 + [f, u64, i, i, p]
    old.qbmx_pt_wide.argtypes = [p] * 12 + [i] * 6 + [u64, i, p]
    refresh1.qbmx_anneal_wide.argtypes = [p] * 10 + [i] * 5 + [f, u64, i, i, p]
    for fn in (old.qbmx_anneal_wide, old.qbmx_pt_wide, refresh1.qbmx_anneal_wide):
        fn.restype = i
    return old, refresh1


def anneal_form(Q, h_extra, S, width, beta=1.0):
    """(J, h, hot, logr) as the wrappers hand ``Q`` (G, n, n) and
    ``h_extra`` (G, B, n) to K4: Metropolis at width 0, heat-bath at
    ``beta`` otherwise."""
    hs, J = split_qubo(Q)
    h = (hs[:, None, :] + h_extra).contiguous()
    if width == 0:
        hot, logr = sa_torch.schedule_params(h, J[:, None], S)
    else:
        hot, logr = gibbs.heat_bath_schedule(h, J[:, None], S, beta)
    return J.contiguous(), h, hot, logr


def problem(rng, width, G, B, n, S, dev, beta=1.0):
    """(Q, h_extra) random QUBOs and (J, h, hot, logr) scheduled as the
    wrappers do (``anneal_form``)."""
    Q = random_qubo_batch(rng, G, n).to(dev)
    h_extra = torch.as_tensor(rng.normal(size=(G, B, n)).astype(np.float32), device=dev)
    return (Q, h_extra), anneal_form(Q, h_extra, S, width, beta)


def median_ms(fn, runs: int) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def turns(first, second, runs: int) -> tuple[list[float], list[float]]:
    """Medians of ``first`` and ``second`` in turns (first, second, second,
    first): ([first's two], [second's two])."""
    t = [median_ms(first, runs), median_ms(second, runs), median_ms(second, runs),
         median_ms(first, runs)]
    return [t[0], t[3]], [t[1], t[2]]


def differ(a, b) -> float:
    return (a != b).reshape(-1, a.shape[-1]).any(dim=1).double().mean().item()


def lib_k4(lib, J, h, hot, logr, R, S, rule, out, seed=7, init01=None, uniforms=None, *,
           parent=False):
    """K4 from another build of its source: by this tree's C interface
    (per-row counts, passed null), or by the parent's (``parent``: none)."""
    G, B, n = h.shape
    Jp = F.pad(J, (0, wide_cuda.row_floats(n) - n)).contiguous()
    head = (Jp.data_ptr(),) if parent else (Jp.data_ptr(), None)
    kernel_call.check_rc("anneal_wide", lib.qbmx_anneal_wide(
        *head, h.data_ptr(), hot.data_ptr(), logr.data_ptr(),
        None if init01 is None else init01.data_ptr(),
        None if uniforms is None else uniforms.data_ptr(), out.data_ptr(), None, None,
        G, B, R, n, S, ctypes.c_float(sa_torch.inv_span(S)), seed, rule,
        wide_cuda.wide_geometry(G, B, R, n).chains_per_block, kernel_call.stream(h.device)))
    return out


def time_k5(old, runs, dev) -> dict:
    """The parent's K5 against this one at the CDQBM (a) PT call."""
    G, B, M, R, n = (K5_CALL[k] for k in ("G", "B", "M", "R", "n"))
    Q, h_extra = cdqbm_a_qubos(B, dev)
    J, h, betas, dbeta = pt_wide_cuda.structured_form(Q, h_extra, M)
    Jp = F.pad(J, (0, wide_cuda.row_floats(n) - n)).contiguous()
    nnz = pt_wide_cuda.group_nnz(pt_wide_cuda.row_nnz(J))
    rule = pt_wide_cuda.pt_wide_geometry(G, B, M, R, n, pt_wide_cuda.padded(max(nnz)))
    old_L = pt_wide_cuda.pt_wide_geometry(G, B, M, R, n).ladders_per_block  # the parent's rule
    out = torch.empty((G, B, R, n), device=dev)
    gen = lambda: torch.Generator().manual_seed(7)
    records = {"nnz": nnz, "geometry": str(rule)}
    for S in (10, 1000):
        run_old = lambda: kernel_call.check_rc("old pt_wide", old.qbmx_pt_wide(
            Jp.data_ptr(), h.data_ptr(), betas.data_ptr(), dbeta.data_ptr(), None, None, None,
            out.data_ptr(), None, None, None, None, G, B, M, R, n, S, 7, old_L,
            kernel_call.stream(dev)))
        new = {path: (lambda path=path, **kw: pt_wide_cuda.launch(
            J, h, betas, dbeta, R, S, path=path, generator=gen(), **kw))
            for path in (pt_wide_cuda.SPARSE, pt_wide_cuda.DENSE)}
        flips = torch.zeros(2, dtype=torch.int64, device=dev)
        new[pt_wide_cuda.SPARSE](flips=flips)
        torch.cuda.synchronize()
        changed, work = (int(v) for v in flips.tolist())
        bound = anneal_bound(G, B, R, n, S, rungs=M, flip_work=work)
        rec = {"flips": changed, "flip_work": work, **bound}
        for path in (pt_wide_cuda.SPARSE, pt_wide_cuda.DENSE):
            rec[f"old_ms vs {path}"], rec[f"{path}_ms"] = turns(run_old, new[path], runs)
            print(f"K5 CDQBM (a) PT G={G} B={B} M={M} R={R} n={n} S={S}: old "
                  f"{rec[f'old_ms vs {path}']} ms, new {path} path {rec[f'{path}_ms']} ms (CUDA "
                  f"events, median of {runs} each, turns old new new old)", flush=True)
        print(f"K5 S={S}: flips {changed}, nonzeros of the changed rows {work}; bound "
              f"{bound['bound_ms']:.4f} ms by {bound['bound_by']}; {rule}", flush=True)
        records[f"S={S}"] = rec
    # the sparse path's ladders a block at S=1000: the rule's against two others
    S = 1000
    rule_run = lambda: pt_wide_cuda.launch(J, h, betas, dbeta, R, S, generator=gen())
    for L in (2, 1):
        geo = pt_wide_cuda.PTWideGeometry.of(G, B, M, R, n, L, 1, rule.nnz_pad)
        forced = lambda geo=geo: pt_wide_cuda.launch(J, h, betas, dbeta, R, S, geometry=geo,
                                                    generator=gen())
        rule_ms, L_ms = turns(rule_run, forced, runs)
        records[f"L={L}"] = {"rule_ms": rule_ms, "forced_ms": L_ms, "geometry": str(geo)}
        print(f"K5 sparse S={S}: {rule.ladders_per_block} ladders a block (the rule) {rule_ms} ms, "
              f"{L} a block {L_ms} ms (turns rule forced forced rule); {geo}", flush=True)
    return records


def time_k4(old, runs, dev) -> dict:
    records = {}
    rng = np.random.default_rng(2024)
    gen = lambda: torch.Generator().manual_seed(7)
    for label, (rule, G, B, n, R, S) in K4_SHAPES.items():
        _, (J, h, hot, logr) = problem(rng, rule, G, B, n, S, dev)
        out = torch.empty((G, B, R, n), device=dev)
        run_old = lambda: lib_k4(old, J, h, hot, logr, R, S, rule, out, parent=True)
        run_new = lambda **kw: wide_cuda.launch(J, h, hot, logr, R, S, rule, generator=gen(),
                                                **kw)
        flips = torch.zeros(2, dtype=torch.int64, device=dev)
        run_new(flips=flips)
        torch.cuda.synchronize()
        changed, work = (int(v) for v in flips.tolist())
        units = n if rule == 0 else heatbath_units(n, rule)
        bound = anneal_bound(G, B, R, n, S, decisions=G * B * R * units * S, flip_work=work)
        old_ms, new_ms = turns(run_old, run_new, runs)
        records[label] = {"old_ms": old_ms, "new_ms": new_ms, "flips": changed,
                          "flip_work": work, **bound}
        print(f"{label}: old {old_ms[0]:.3f} / {old_ms[1]:.3f} ms, new {new_ms[0]:.3f} / "
              f"{new_ms[1]:.3f} ms (CUDA events, median of {runs} each, turns old new new "
              f"old); flips {changed}, their rows' nonzeros {work}; bound "
              f"{bound['bound_ms']:.4f} ms by {bound['bound_by']}", flush=True)
    return records


def build_thread_wide() -> ctypes.CDLL:
    """K1 and K2 with the THREAD layout up to n = ``THREAD_WIDE``, by this
    tree's C interface."""
    compile_, link = build("kernels_thread_wide", sorted(_build.CSRC.glob("sa_*.cu")),
                           (f"-DQBMX_THREAD_MAX_N={THREAD_WIDE}",))
    _build._run_all(compile_)
    _build._run_all([link])
    lib = ctypes.CDLL(link[link.index("-o") + 1])
    p, i, f, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_ulonglong
    lib.qbmx_sa_metropolis.argtypes = [p] * 9 + [i] * 5 + [f, u64, i, p]
    lib.qbmx_sa_heatbath.argtypes = [p] * 9 + [i] * 5 + [f, u64, i, i, p]
    for fn in (lib.qbmx_sa_metropolis, lib.qbmx_sa_heatbath, lib.qbmx_sa_metropolis_thread_max_n,
               lib.qbmx_sa_heatbath_thread_max_n):
        fn.restype = i
    if lib.qbmx_sa_metropolis_thread_max_n() != THREAD_WIDE \
            or lib.qbmx_sa_heatbath_thread_max_n() != THREAD_WIDE:
        raise RuntimeError("compare_kernels: the wide THREAD build did not take its bound")
    return lib


def lib_k1k2(lib, width, J, h, hot, logr, R, S, lanes, out, seed=7):
    """K1 (``width`` 0) or K2 from another build, a layout forced, Philox mode."""
    G, B, n = h.shape
    head = (J.data_ptr(), h.data_ptr(), hot.data_ptr(), logr.data_ptr(), None, None,
            out.data_ptr(), None, None, G, B, R, n, S, ctypes.c_float(sa_torch.inv_span(S)),
            seed)
    stream = kernel_call.stream(h.device)
    if width == 0:
        rc = lib.qbmx_sa_metropolis(*head, lanes, stream)
    else:
        rc = lib.qbmx_sa_heatbath(*head, width, lanes, stream)
    kernel_call.check_rc("sa_metropolis" if width == 0 else "sa_heatbath", rc)
    return out


def layouts_at(n: int, width: int) -> list[int]:
    """The layouts (lanes a chain) the layouts part times at width ``n``."""
    return [L for L in (1, *kernel_call.LANES)
            if n <= (THREAD_WIDE if L == 1 else kernel_call.max_n(L, width))]


def time_layouts(runs, dev) -> dict:
    lib = build_thread_wide()
    records = {}
    for kernel, width in (("K1", 0), ("K2 pair", 2), ("K2 single", 1), ("K2 quad", 4)):
        for n in LAYOUT_NS:
            for chains, (G, B, R) in LAYOUT_CHAINS.items():
                S = LAYOUT_S
                _, (J, h, hot, logr) = problem(np.random.default_rng(2024), width, G, B, n, S,
                                               dev)
                out = torch.empty((G, B, R, n), device=dev)
                order = layouts_at(n, width)
                run = {L: (lambda L=L: lib_k1k2(lib, width, J, h, hot, logr, R, S, L, out))
                       for L in order}
                # a rotation there and back: each layout timed twice, the
                # first and last of the rotation beside each other
                ms = {L: [] for L in order}
                for L in [*order, *reversed(order)]:
                    ms[L].append(median_ms(run[L], runs))
                chosen = kernel_call.chain_layout(G, B, R, n, width=width).lanes
                best = min(order, key=lambda L: sum(ms[L]))
                records[f"{kernel} n={n} chains={chains}"] = {
                    "kernel": kernel, "n": n, "chains": chains, "G": G, "B": B, "R": R, "S": S,
                    "ms": {str(L): ms[L] for L in order}, "best_lanes": best,
                    "chosen_lanes": chosen}
                print(f"{kernel} n={n} chains={chains} (G={G} B={B} R={R} S={S}): "
                      + ", ".join(f"{L} lanes {ms[L][0]:.3f}/{ms[L][1]:.3f}" for L in order)
                      + f" ms; best {best}, chain_layout {chosen}", flush=True)
                del J, h, hot, logr, out
    for kernel in ("K1", "K2 pair", "K2 single", "K2 quad"):  # the best layout at each n, chains
        print(f"{kernel}: best lanes a chain (rows n, columns chains {list(LAYOUT_CHAINS)})")
        for n in LAYOUT_NS:
            print(f"  n={n:3d}: " + " ".join(
                f"{records[f'{kernel} n={n} chains={c}']['best_lanes']:>3d}"
                for c in LAYOUT_CHAINS))
    return records


def pt_layouts_at(n: int, M: int) -> list[int]:
    """K3's layouts (lanes a rung) that take width n and M rungs."""
    return [L for L in pt_cuda.LAYOUTS
            if n <= pt_cuda.max_n(L) and (L != pt_cuda.RUNG or M <= pt_cuda.RUNG_MAX_M)]


def time_pt_layouts(runs, dev) -> dict:
    """K3's layouts, each forced, at every n of ``PT_LAYOUT_NS`` and call
    of ``PT_LAYOUT_CALLS`` (S = ``LAYOUT_S``, Philox mode, random QUBOs),
    in turns (a rotation through the layouts and back): the measurements
    ``pt_cuda.pt_layout``'s boundaries rest on, with the rule's pick beside
    the fastest."""
    records = {}
    gen = lambda: torch.Generator().manual_seed(7)
    for (M, rungs), (B, R) in PT_LAYOUT_CALLS.items():
        for n in PT_LAYOUT_NS:
            S = LAYOUT_S
            Q = random_qubo_batch(np.random.default_rng(2024), B, n).to(dev)
            order = pt_layouts_at(n, M)
            run = {L: (lambda L=L: pt_cuda.pt_sample_batch_cuda(
                Q, R, S, num_replicas=M, generator=gen(), _layout=L)) for L in order}
            ms = {L: [] for L in order}
            for L in [*order, *reversed(order)]:
                ms[L].append(median_ms(run[L], runs))
            chosen = pt_cuda.pt_layout(B, M, R, n).lanes
            best = min(order, key=lambda L: sum(ms[L]))
            ratio = sum(ms[chosen]) / sum(ms[best])
            records[f"K3 M={M} rungs={rungs} n={n}"] = {
                "n": n, "M": M, "rungs": rungs, "B": B, "R": R, "S": S,
                "ms": {str(L): ms[L] for L in order}, "best_lanes": best,
                "chosen_lanes": chosen, "chosen_over_best": ratio}
            print(f"K3 M={M} rungs={rungs} n={n} (B={B} R={R} S={S}): "
                  + ", ".join(f"{L} lanes {ms[L][0]:.3f}/{ms[L][1]:.3f}" for L in order)
                  + f" ms; best {best}, pt_layout {chosen} ({ratio:.3f}x)", flush=True)
            del Q
    for M, rungs in PT_LAYOUT_CALLS:  # the best layout at each n and the rule's pick
        print(f"K3 M={M} rungs={rungs}: best lanes a rung / pt_layout's, by n")
        print("  " + " ".join(
            f"n={n}:{records[f'K3 M={M} rungs={rungs} n={n}']['best_lanes']}"
            f"/{records[f'K3 M={M} rungs={rungs} n={n}']['chosen_lanes']}" for n in PT_LAYOUT_NS))
    worst = max(records.values(), key=lambda r: r["chosen_over_best"])
    print(f"K3: the rule's pick is at most {worst['chosen_over_best']:.3f}x the fastest "
          f"(M={worst['M']} rungs={worst['rungs']} n={worst['n']})", flush=True)
    return records


def time_pt_parent(parent_csrc: Path, runs: int, dev) -> dict:
    """K3 a rung a thread from ``PT_PARENT``'s ``pt_heatbath.cu`` (its C
    interface: the layout 0 for a rung a thread) against this tree's, both
    launched alone on the same inputs, in turns (parent, new, new, parent),
    Philox mode on one seed, at ``PT_PARENT_CALLS``; this tree's also
    through the sampler's wrapper; and their samples, equal bit for bit."""
    compile_, link = build("kernels_pt_parent", [parent_csrc / "pt_heatbath.cu"])
    _build._run_all(compile_)
    _build._run_all([link])
    lib = ctypes.CDLL(link[link.index("-o") + 1])
    p, i, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong
    lib.qbmx_pt_heatbath.argtypes = [p] * 8 + [i] * 5 + [u64, i, p]
    lib.qbmx_pt_heatbath.restype = i
    records = {}
    for label, (B, M, R, n, S) in PT_PARENT_CALLS.items():
        Q = random_qubo_batch(np.random.default_rng(2024), B, n).to(dev)
        h, J = (t.contiguous() for t in split_qubo(Q))
        betas, dbeta = tempering.ladder_betas(Q, M)
        seed = draw_seed(torch.Generator().manual_seed(7))
        old = torch.empty((B, R, n), device=dev)
        run_old = lambda: kernel_call.check_rc("parent pt_heatbath", lib.qbmx_pt_heatbath(
            J.data_ptr(), h.data_ptr(), betas.data_ptr(), dbeta.data_ptr(), None, None, None,
            old.data_ptr(), B, M, R, n, S, seed, 0, kernel_call.stream(dev)))
        lanes = pt_cuda.pt_layout(B, M, R, n).lanes
        new = torch.empty_like(old)
        run_new = lambda: kernel_call.check_rc("pt_heatbath", _build.load_kernels().qbmx_pt_heatbath(
            J.data_ptr(), h.data_ptr(), betas.data_ptr(), dbeta.data_ptr(), None, None, None,
            new.data_ptr(), B, M, R, n, S, seed, lanes, kernel_call.stream(dev)))
        wrapper = lambda: pt_cuda.pt_sample_batch_cuda(
            Q, R, S, num_replicas=M, generator=torch.Generator().manual_seed(7))
        run_old()
        run_new()
        same = torch.equal(old, new) and torch.equal(new, wrapper())
        old_ms, new_ms = turns(run_old, run_new, runs)
        wrapper_ms = median_ms(wrapper, runs)
        records[label] = {"B": B, "M": M, "R": R, "n": n, "S": S, "parent_ms": old_ms,
                          "new_ms": new_ms, "new_lanes": lanes, "wrapper_ms": wrapper_ms,
                          "samples_equal": same}
        print(f"K3 {label} (B={B} M={M} R={R} n={n} S={S}): {PT_PARENT}'s a rung a thread "
              f"{old_ms[0]:.3f} / {old_ms[1]:.3f} ms, this tree's ({lanes} lanes) "
              f"{new_ms[0]:.3f} / {new_ms[1]:.3f} ms (the kernels alone; CUDA events, median of "
              f"{runs} each, turns parent new new parent); through the sampler's wrapper "
              f"{wrapper_ms:.3f} ms; samples equal bit for bit: {same}", flush=True)
        del Q, h, J, old
    return records


def k4_agreement(refresh1, dev) -> dict:
    G, B, n, R, S, beta = (K4_AGREE[k] for k in ("G", "B", "n", "R", "S", "beta"))
    records = {}
    for name, rule in RULES.items():
        counts = {"new": 0.0, "refresh1": 0.0, "new vs refresh1": 0.0}
        for seed in K4_AGREE["seeds"]:
            rng = np.random.default_rng(300 + seed)
            (Q, h_extra), (J, h, hot, logr) = problem(rng, rule, G, B, n, S, dev, beta)
            init01 = torch.as_tensor((rng.random((G, B, R, n)) < 0.5).astype(np.float32),
                                     device=dev)
            u = torch.as_tensor(np.clip(rng.random((S, G, B, n, R)), 1e-6, 1 - 1e-6)
                                .astype(np.float32), device=dev)
            if rule == wide_cuda.METROPOLIS:
                plain = sa_torch.sa_sample_groups_plain(Q, h_extra, R, S, host_variates=(init01, u))
            else:
                plain = gibbs.gibbs_sample_groups_plain(
                    Q, h_extra, R, S, beta=beta, pair=rule == 2, quad=rule == 4,
                    host_variates=(init01, u))
            new = wide_cuda.launch(J, h, hot, logr, R, S, rule, host_variates=(init01, u))
            out_r1 = lib_k4(refresh1, J, h, hot, logr, R, S, rule, torch.empty_like(new), 0,
                            init01, u)
            torch.cuda.synchronize()
            for key, a, b in (("new", new, plain), ("refresh1", out_r1, plain),
                              ("new vs refresh1", new, out_r1)):
                counts[key] += differ(a, b) / len(K4_AGREE["seeds"])
        records[name] = counts
        print(f"K4 agreement {name} G={G} B={B} n={n} R={R} S={S} (beta {beta}), "
              f"{len(K4_AGREE['seeds'])} seeds: chains differing from plain: K4 "
              f"{counts['new']:.5f}, K4 refreshed every sweep {counts['refresh1']:.5f}; "
              f"between the two {counts['new vs refresh1']:.5f}", flush=True)
    return records


def flat_step_qubos(n_hidden: int, B: int, device, restricted: bool = True, seed: int = 19):
    """The flat model's step QUBOs at ``qbm_main -hn n_hidden`` (784
    inputs, n = n_hidden + 1) on a batch of B random images made from
    ``seed``, from the seed's untrained parameters: (Q2 (2, n, n), h2 (2, B,
    n)), the clamped and unclamped groups of the step's one sampler call.
    Restricted (``qm.main``'s default), J_g is all zeros but the output's
    row and column; unrestricted (the CLI's ``-r False``), a dense
    ``w_hh``.  For checks and timings of the kernels; the models never
    call it."""
    m = DiscQBM(dim_input=784, n_hidden_nodes=n_hidden, sample_count=100, anneal_steps=5,
                restricted=restricted, seed=seed, device=device)
    x = torch.as_tensor(np.random.default_rng(seed).random((B, 784), dtype=np.float32),
                        device=device)
    return m.step_qubos(m.params, x, m._label_vec(torch.arange(B, device=device) % 2))


# the split variants of the parent's global layouts: (decisions, field pass)
SPLIT_VARIANTS = {"full": (1, 1), "no_field_pass": (1, 0), "loads_only": (0, 0)}
# text of anneal_tiles.cuh -> the split build's (each found once): the parent's,
# whose counting build counts the chain-tiles with a change in place of the
# nonzeros of the changed rows, and this tree's
SPLIT_PATCH = (
    ("      if (active && c == 0) {    // the tile's decisions",
     "      if (QBMX_SPLIT_DECIDE && active && c == 0) {    // the tile's decisions"),
    ("      if (active && any) {  // the tile's changes onto the chunk's other fields",
     "      if (COUNT && active && any && c == 0) ++work;  // a tile with a change\n"
     "      if (QBMX_SPLIT_PASS && active && any) {  // the tile's changes"),
    ("    count_rows<M, COUNT>(nnz, i0 + rr, d, work);\n    if (refresh) __syncwarp();",
     "    if (refresh) __syncwarp();"),
)
SPLIT_PATCH_NEW = (
    ("      changed += window_decisions<RULE, SPARSE, COUNT>(",
     "      if (QBMX_SPLIT_DECIDE) changed += window_decisions<RULE, SPARSE, COUNT>("),
    ("      if (active && count > 0) sparse_pass(",
     "      if (QBMX_SPLIT_PASS && active && count > 0) sparse_pass("),
    ("        if (active && count > 0)\n          dense_chunk(",
     "        if (QBMX_SPLIT_PASS && active && count > 0)\n          dense_chunk("),
)


def build_split(csrc: Path, patch: tuple, tag: str) -> dict:
    """K4 and K5 from ``csrc`` built three ways (``SPLIT_VARIANTS``): whole,
    without the field pass, and without the decisions too (the loads of J_g
    and of the fields, their barriers, the launch, init and outputs), by
    the text ``patch``; the libraries are declared with the parent's C
    interface (``tag`` ``PARENT``) or this tree's."""
    import shutil

    jobs = {}
    for name, (decide, pass_) in SPLIT_VARIANTS.items():
        src = _build.BUILD_DIR.parent / f"split_{tag}_{name}" / "csrc"
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(csrc, src)
        text = (src / "anneal_tiles.cuh").read_text()
        for old_text, new_text in patch:
            if text.count(old_text) != 1:
                raise SystemExit(f"compare_kernels: {csrc} is not the {tag} tree's csrc")
            text = text.replace(old_text, new_text)
        (src / "anneal_tiles.cuh").write_text(text)
        jobs[name] = build(f"kernels_split_{tag}_{name}",
                           [src / "anneal_wide.cu", src / "pt_wide.cu"],
                           (f"-DQBMX_SPLIT_DECIDE={decide}", f"-DQBMX_SPLIT_PASS={pass_}"))
    _build._run_all([c for compile_, _ in jobs.values() for c in compile_])
    _build._run_all([link for _, link in jobs.values()])
    libs = {}
    p, i, f, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_ulonglong
    for name, (_, link) in jobs.items():
        lib = ctypes.CDLL(link[link.index("-o") + 1])
        if tag == PARENT:
            lib.qbmx_anneal_wide.argtypes = [p] * 12 + [i] * 5 + [f, u64, i, i, p]
            lib.qbmx_pt_wide_global.argtypes = [p] * 17 + [i] * 6 + [u64, i, i, p]
            lib.qbmx_anneal_wide.restype = lib.qbmx_pt_wide_global.restype = i
        else:
            for fn in ("qbmx_anneal_wide", "qbmx_pt_wide_global"):
                getattr(lib, fn).argtypes = getattr(_build.load_kernels(), fn).argtypes
                getattr(lib, fn).restype = i
        libs[name] = lib
    return libs


@contextlib.contextmanager
def kernels_from(lib):
    """The wrappers launch from ``lib`` (a split build of this tree) inside."""
    saved = _build._lib
    _build._lib = lib
    try:
        yield
    finally:
        _build._lib = saved


def parent_k4_global(lib, J, h, hot, logr, R, S, rule, flips=None):
    """K4's global-field layout from a build of the parent's sources, by
    its C interface, on 31 chains a block (the rule's at 4,000 chains)."""
    G, B, n = h.shape
    frow = wide_cuda.global_row_floats(n)
    Jp = F.pad(J, (0, frow - n)).contiguous()
    fscr = torch.zeros((G * B * R, frow), dtype=torch.float32, device=h.device)
    sscr = torch.zeros((G * B * R, frow), dtype=torch.uint8, device=h.device)
    out = torch.empty((G, B, R, n), device=h.device)
    nnz = None if flips is None else pt_wide_cuda.row_nnz(J)
    kernel_call.check_rc("parent anneal_wide global", lib.qbmx_anneal_wide(
        Jp.data_ptr(), None if nnz is None else nnz.data_ptr(), h.data_ptr(), hot.data_ptr(),
        logr.data_ptr(), None, None, out.data_ptr(), None,
        None if flips is None else flips.data_ptr(), fscr.data_ptr(), sscr.data_ptr(),
        G, B, R, n, S, ctypes.c_float(sa_torch.inv_span(S)), 7, rule,
        wide_cuda.layout_geometry(G, B, R, n, wide_cuda.GLOBAL).chains_per_block,
        kernel_call.stream(h.device)))
    return out


def parent_k5_global(lib, J, h, betas, dbeta, R, S, flips=None):
    """K5's global path from a build of the parent's sources (S + 1 launches)."""
    G, B, n = h.shape
    M = betas.shape[-1]
    frow, states = wide_cuda.global_row_floats(n), G * B * R * M
    Jp = F.pad(J, (0, frow - n)).contiguous()
    fields = torch.zeros((states, frow), dtype=torch.float32, device=h.device)
    state = torch.zeros((states, frow), dtype=torch.uint8, device=h.device)
    energies = torch.empty((2, states), dtype=torch.float32, device=h.device)
    rho = torch.empty((states,), dtype=torch.int32, device=h.device)
    out = torch.empty((G, B, R, n), device=h.device)
    nnz = None if flips is None else pt_wide_cuda.row_nnz(J)
    kernel_call.check_rc("parent pt_wide_global", lib.qbmx_pt_wide_global(
        Jp.data_ptr(), None if nnz is None else nnz.data_ptr(), h.data_ptr(), betas.data_ptr(),
        dbeta.data_ptr(), None, None, None, out.data_ptr(), None, None, None,
        None if flips is None else flips.data_ptr(), fields.data_ptr(), state.data_ptr(),
        energies.data_ptr(), rho.data_ptr(), G, B, M, R, n, S, 7,
        pt_wide_cuda.global_warps(G, B, M, R), pt_wide_cuda.var_shift(n),
        kernel_call.stream(h.device)))
    return out


def time_split(libs: dict, parent: bool, runs: int, dev) -> dict:
    """The global layouts' K4 (Metropolis, pair) and K5 (M=8) at both H=3400
    calls, from each of ``build_split``'s builds ``libs``: whole, without
    the field pass, and with the loads alone, in the order whole, no pass,
    loads, loads, no pass, whole (the mean of each one's two medians), the
    whole one also at S=1 (its refresh sweep alone); and, by the whole
    counting build, the changes and -- ``parent``, 210c6d7's build by its C
    interface -- the (chain, tile) pairs with a change, or -- this tree's,
    through the wrappers on the pass the density rule picks -- the
    nonzeros of the changed rows."""
    R, S, M = 100, 5, 8
    gen = lambda: torch.Generator().manual_seed(7)
    records = {}
    for restricted in (True, False):
        Qs, hs = flat_step_qubos(3400, 20, dev, restricted, seed=3400)
        G, B, n = hs.shape
        call = "restricted" if restricted else "dense (-r False)"
        for kernel in ("K4 Metropolis", "K4 pair", f"K5 M={M}"):
            if kernel.startswith("K4"):
                rule = wide_cuda.METROPOLIS if kernel == "K4 Metropolis" else wide_cuda.PAIR
                J, h, hot, logr = anneal_form(Qs, hs, S, rule)
                launch = (lambda lib, S, flips: parent_k4_global(lib, J, h, hot, logr, R, S, rule,
                                                                 flips)) if parent else \
                    (lambda lib, S, flips: wide_cuda.launch(J, h, hot, logr, R, S, rule,
                                                            generator=gen(), flips=flips))
            else:
                J, h, betas, dbeta = pt_wide_cuda.structured_form(Qs, hs, M)
                launch = (lambda lib, S, flips: parent_k5_global(lib, J, h, betas, dbeta, R, S,
                                                                 flips)) if parent else \
                    (lambda lib, S, flips: pt_wide_cuda.launch(J, h, betas, dbeta, R, S,
                                                               generator=gen(), flips=flips))

            def run(name, S=S, flips=None):
                with kernels_from(libs[name]):  # the wrappers launch from this build
                    return launch(libs[name], S, flips)

            times = {name: [] for name in SPLIT_VARIANTS}
            for name in [*SPLIT_VARIANTS, *reversed(SPLIT_VARIANTS)]:
                times[name].append(median_ms(lambda: run(name), runs))
            rec = {name: statistics.mean(v) for name, v in times.items()}
            rec["full_S1"] = median_ms(lambda: run("full", 1), runs)
            flips = torch.zeros(2, dtype=torch.int64, device=dev)
            run("full", flips=flips)
            torch.cuda.synchronize()
            second = "tiles_with_a_change" if parent else "flip_work"
            rec["changes"], rec[second] = (int(v) for v in flips.tolist())
            rec["field_pass_ms"] = rec["full"] - rec["no_field_pass"]
            rec["decisions_ms"] = rec["no_field_pass"] - rec["loads_only"]
            if parent:
                tiles = G * B * R * (M if kernel.startswith("K5") else 1) * S * -(-n // 8)
                counted = f"{rec[second]} of {tiles} chain-tiles with a change"
                where = PARENT
            else:
                counted = f"{rec[second]} nonzeros of their rows"
                where = "this tree, the " + ("sparse" if wide_cuda.sparse_pass(
                    pt_wide_cuda.row_nnz(J), n) else "dense") + " pass"
            records[f"{kernel}, {call}"] = rec
            print(f"split {kernel} global ({where}), H=3400 {call} call (G={G} B={B} n={n} R={R} "
                  f"S={S}): whole {rec['full']:.3f} ms = field pass {rec['field_pass_ms']:.3f} + "
                  f"decisions {rec['decisions_ms']:.3f} + loads, barriers and the rest "
                  f"{rec['loads_only']:.3f} ms; at S=1 (its refresh sweep) {rec['full_S1']:.3f} ms; "
                  f"{rec['changes']} changes, {counted} (CUDA events, median of {runs}, each "
                  "variant twice in turns)", flush=True)
        del Qs, hs
    return records


def build_parent(parent_csrc: Path) -> ctypes.CDLL:
    """The parent's K4 and K5, as they are, declared with their C interface."""
    compile_, link = build("kernels_parent", [parent_csrc / "anneal_wide.cu",
                                              parent_csrc / "pt_wide.cu"])
    _build._run_all(compile_)
    _build._run_all([link])
    lib = ctypes.CDLL(link[link.index("-o") + 1])
    p, i, f, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_ulonglong
    lib.qbmx_anneal_wide.argtypes = [p] * 12 + [i] * 5 + [f, u64, i, i, p]
    lib.qbmx_pt_wide_global.argtypes = [p] * 17 + [i] * 6 + [u64, i, i, p]
    lib.qbmx_anneal_wide.restype = lib.qbmx_pt_wide_global.restype = i
    return lib


def global_calls(dev) -> dict:
    """The global part's calls: label -> (Q, h_extra, R, M, S): both H=3400
    step calls (G=2 B=20 R=100 n=3401 S=5; K5 at M=8, 32,000 rungs) and
    random dense QUBOs at n = 4096 and 8192 (K4 on 256 chains, K5 on 256
    rungs: M=8 over 32 ladders)."""
    calls = {}
    for restricted in (True, False):
        Q, he = flat_step_qubos(3400, 20, dev, restricted, seed=3400)
        calls["H=3400 " + ("restricted" if restricted else "dense (-r False)")] = (Q, he, 100,
                                                                                  8, 5)
    rng = np.random.default_rng(4096)
    for label, (G, B, R, Rk5, n, S) in GLOBAL_WIDE.items():
        Q = random_qubo_batch(rng, G, n).to(dev)
        he = torch.as_tensor(rng.normal(size=(G, B, n)).astype(np.float32), device=dev)
        calls[label] = (Q, he, R, 8, S, Rk5)
    return calls


def time_global(parent_csrc: Path, runs: int, dev) -> dict:
    """The parent's global layouts (K4 Metropolis and pair, K5) against this
    tree's, in turns (parent, new, new, parent) at ``global_calls``; the new
    ones on the pass the density rule picks, and at the H=3400 calls also on
    the other pass, forced; each call's changes and the nonzeros of their
    rows counted once, for the bound (``qbmx_torch.utils.roofline``)."""
    parent = build_parent(parent_csrc)
    gen = lambda: torch.Generator().manual_seed(7)
    records = {}
    for label, (Q, he, R, M, S, *rk5) in global_calls(dev).items():
        G, B, n = he.shape
        J0 = split_qubo(Q)[1]
        rule_pass = "sparse" if wide_cuda.sparse_pass(pt_wide_cuda.row_nnz(J0), n) else "dense"
        other = {"sparse": "dense", "dense": "sparse"}[rule_pass]
        passes = (rule_pass, other) if label.startswith("H=3400") else (rule_pass,)
        for kernel in ("K4 Metropolis", "K4 pair", f"K5 M={M}"):
            if kernel.startswith("K4"):
                rule = wide_cuda.METROPOLIS if kernel == "K4 Metropolis" else wide_cuda.PAIR
                J, h, hot, logr = anneal_form(Q, he, S, rule)
                geo = wide_cuda.layout_geometry(G, B, R, n, wide_cuda.GLOBAL)
                old = lambda: parent_k4_global(parent, J, h, hot, logr, R, S, rule)
                new = lambda fp, **kw: wide_cuda.launch(J, h, hot, logr, R, S, rule,
                                                        generator=gen(), geometry=geo,
                                                        field_pass=fp, **kw)
                rungs, Rc = 1, R
            else:
                Rc = rk5[0] if rk5 else R
                J, h, betas, dbeta = pt_wide_cuda.structured_form(Q, he, M)
                old = lambda: parent_k5_global(parent, J, h, betas, dbeta, Rc, S)
                new = lambda fp, **kw: pt_wide_cuda.launch(
                    J, h, betas, dbeta, Rc, S, generator=gen(), path=pt_wide_cuda.GLOBAL,
                    field_pass=fp, **kw)
                rungs = M
            flips = torch.zeros(2, dtype=torch.int64, device=dev)
            new(rule_pass, flips=flips)
            torch.cuda.synchronize()
            changed, work = (int(v) for v in flips.tolist())
            bound = anneal_bound(G, B, Rc, n, S, rungs=rungs, flip_work=work,
                                 decisions=G * B * Rc * rungs * S *
                                 (heatbath_units(n, 2) if kernel == "K4 pair" else n))
            rec = {"flips": changed, "flip_work": work, "rule_pass": rule_pass, **bound}
            for fp in passes:
                rec[f"parent_ms vs {fp}"], rec[f"{fp}_ms"] = turns(old, lambda fp=fp: new(fp),
                                                                   runs)
                print(f"global {kernel} {label} (G={G} B={B} R={Rc} n={n} S={S}): parent "
                      f"{rec[f'parent_ms vs {fp}'][0]:.3f} / {rec[f'parent_ms vs {fp}'][1]:.3f} "
                      f"ms, new {fp} pass{' (the rule)' if fp == rule_pass else ' (forced)'} "
                      f"{rec[f'{fp}_ms'][0]:.3f} / {rec[f'{fp}_ms'][1]:.3f} ms (CUDA events, "
                      f"median of {runs} each, turns parent new new parent); {changed} changes, "
                      f"{work} nonzeros of their rows; bound {bound['bound_ms']:.4f} ms by "
                      f"{bound['bound_by']}", flush=True)
            records[f"{kernel}, {label}"] = rec
    return records


def time_density(runs: int, dev) -> dict:
    """The density rule's tie: at n = 3401 (the H=3400 step's G=2 B=20 R=100
    S=5, K5 at M=8) on random QUBOs whose couplings are ``DENSITIES`` of
    nonzeros, each kernel with its sparse pass and its dense pass forced, in
    turns (sparse, dense, dense, sparse)."""
    G, B, R, n, S, M = 2, 20, 100, 3401, 5, 8
    gen = lambda: torch.Generator().manual_seed(7)
    rng = np.random.default_rng(3401)
    records = {}
    for density in DENSITIES:
        Q = random_qubo_batch(rng, G, n).to(dev)
        keep = torch.as_tensor(rng.random((G, n, n)) < density, device=dev)
        Q = torch.where(keep | torch.eye(n, dtype=torch.bool, device=dev), Q, torch.zeros_like(Q))
        he = torch.as_tensor(rng.normal(size=(G, B, n)).astype(np.float32), device=dev)
        counts = pt_wide_cuda.row_nnz(split_qubo(Q)[1])
        share = int(counts.sum(-1).max()) / (n * n)
        for kernel in ("K4 Metropolis", "K4 pair", f"K5 M={M}"):
            if kernel.startswith("K4"):
                rule = wide_cuda.METROPOLIS if kernel == "K4 Metropolis" else wide_cuda.PAIR
                J, h, hot, logr = anneal_form(Q, he, S, rule)
                run = lambda fp: wide_cuda.launch(J, h, hot, logr, R, S, rule, generator=gen(),
                                                  field_pass=fp)
            else:
                J, h, betas, dbeta = pt_wide_cuda.structured_form(Q, he, M)
                run = lambda fp: pt_wide_cuda.launch(J, h, betas, dbeta, R, S, generator=gen(),
                                                     path=pt_wide_cuda.GLOBAL, field_pass=fp)
            sparse_ms, dense_ms = turns(lambda: run("sparse"), lambda: run("dense"), runs)
            records[f"{kernel}, density {density}"] = {
                "share": share, "sparse_ms": sparse_ms, "dense_ms": dense_ms,
                "rule": "sparse" if wide_cuda.sparse_pass(counts, n) else "dense"}
            print(f"density {kernel} n={n} G={G} B={B} R={R} S={S}: J_g {share:.4f} nonzeros "
                  f"(the densest group): sparse pass {sparse_ms[0]:.3f} / {sparse_ms[1]:.3f} ms, "
                  f"dense pass {dense_ms[0]:.3f} / {dense_ms[1]:.3f} ms (turns sparse dense "
                  f"dense sparse, median of {runs}); the rule (SPARSE_DENSITY "
                  f"{wide_cuda.SPARSE_DENSITY}) takes the "
                  f"{records[f'{kernel}, density {density}']['rule']} pass", flush=True)
        del Q, he, keep
    return records


def shared_calls(dev) -> dict:
    """The sparse_shared part's calls: label -> (Q, h_extra), the main
    paths' own step QUBOs (untrained parameters)."""
    sweep = [cdqbm_a_qubos(20, dev, seed) for seed in range(10)]
    return {
        "CDQBM (a) G=2 B=20 R=100 n=717": cdqbm_a_qubos(20, dev),
        "CDQBM (a) 10-seed sweep G=20 B=20 R=100 n=717": (
            torch.cat([q for q, _ in sweep]), torch.cat([h for _, h in sweep])),
        "qbm_main -hn 300 -r True G=2 B=73 R=100 n=301": flat_step_qubos(300, 73, dev),
        "qbm_main -hn 300 -r True -b 20 G=2 B=20 R=100 n=301": flat_step_qubos(300, 20, dev),
        "qbm_main -hn 700 -r True G=2 B=73 R=100 n=701": flat_step_qubos(700, 73, dev),
    }


def shared_paths(J, h, hot, logr, R, S, rule, gen):
    """K4's shared layout forced onto each path: path -> launch(**kw)."""
    return {path: (lambda path=path, **kw: wide_cuda.launch(
        J, h, hot, logr, R, S, rule, generator=gen(), field_pass=path, **kw))
        for path in (wide_cuda.DENSE, wide_cuda.SPARSE)}


def call_bound(launch, G, B, R, n, S, rule, dev) -> dict:
    """The bound of a K4 call from the changes and the nonzeros of their
    rows that ``launch(flips=...)`` counts (``qbmx_torch.utils.roofline``)."""
    flips = torch.zeros(2, dtype=torch.int64, device=dev)
    launch(flips=flips)
    torch.cuda.synchronize()
    changed, work = (int(v) for v in flips.tolist())
    units = n if rule == wide_cuda.METROPOLIS else heatbath_units(n, rule)
    return {"flips": changed, "flip_work": work,
            **anneal_bound(G, B, R, n, S, decisions=G * B * R * units * S, flip_work=work)}


def time_sparse_shared(runs: int, dev) -> dict:
    """The shared layout's sparse path against its dense path, each forced,
    in turns (dense, sparse, sparse, dense), at ``shared_calls``, S=1000,
    Metropolis and pair, beside the bound."""
    R, S = 100, 1000
    gen = lambda: torch.Generator().manual_seed(7)
    records = {}
    for label, (Q, he) in shared_calls(dev).items():
        G, B, n = he.shape
        nnz = pt_wide_cuda.group_nnz(pt_wide_cuda.row_nnz(split_qubo(Q)[1]))
        geo = wide_cuda.wide_geometry(G, B, R, n)
        rule_path = wide_cuda.shared_path(nnz, n, geo.chains_per_block)
        for kernel, rule in (("Metropolis", wide_cuda.METROPOLIS), ("pair", wide_cuda.PAIR)):
            J, h, hot, logr = anneal_form(Q, he, S, rule)
            run = shared_paths(J, h, hot, logr, R, S, rule, gen)
            rec = {"nnz": nnz, "share": max(nnz) / n**2, "rule_path": rule_path,
                   "chains_per_block": geo.chains_per_block, "grid": geo.grid,
                   "sparse_smem": wide_cuda.sparse_smem_bytes(
                       n, geo.chains_per_block, pt_wide_cuda.padded(max(nnz))),
                   "dense_smem": geo.smem,
                   **call_bound(run[wide_cuda.SPARSE], G, B, R, n, S, rule, dev)}
            rec["dense_ms"], rec["sparse_ms"] = turns(run[wide_cuda.DENSE],
                                                      run[wide_cuda.SPARSE], runs)
            records[f"K4 {kernel}, {label}"] = rec
            print(f"sparse_shared K4 {kernel} {label} S={S} (J_g {rec['share']:.4f} nonzeros, "
                  f"the rule's path {rule_path}, {geo.chains_per_block} chains a block on a grid "
                  f"of {geo.grid}): dense path {rec['dense_ms'][0]:.3f} / {rec['dense_ms'][1]:.3f}"
                  f" ms, sparse path {rec['sparse_ms'][0]:.3f} / {rec['sparse_ms'][1]:.3f} ms "
                  f"(CUDA events, median of {runs} each, turns dense sparse sparse dense); "
                  f"{rec['flips']} changes, {rec['flip_work']} nonzeros of their rows; bound "
                  f"{rec['bound_ms']:.4f} ms by {rec['bound_by']}", flush=True)
        del Q, he
    return records


def time_sparse_density(runs: int, dev) -> dict:
    """The tie of ``wide_cuda.shared_path``: both shared paths forced, in
    turns (dense, sparse, sparse, dense), on random QUBOs whose J_g holds
    ``SHARED_DENSITIES`` of nonzeros, at ``SHARED_DENSITY_NS`` and
    ``SHARED_DENSITY_CHAINS``, S = ``SHARED_DENSITY_S``, Metropolis and
    pair; a share whose row lists do not fit beside the rule's chains is
    recorded as such."""
    S = SHARED_DENSITY_S
    gen = lambda: torch.Generator().manual_seed(7)
    rng = np.random.default_rng(717)
    records = {}
    for n in SHARED_DENSITY_NS:
        for chains, (G, B, R) in SHARED_DENSITY_CHAINS.items():
            C = wide_cuda.wide_geometry(G, B, R, n).chains_per_block
            for density in SHARED_DENSITIES:
                # an upper-triangular Q whose J_g holds about `density` nonzeros
                Q = random_qubo_batch(rng, G, n).to(dev)
                keep = torch.as_tensor(rng.random((G, n, n)) < density, device=dev)
                Q = torch.where(keep | torch.eye(n, dtype=torch.bool, device=dev), Q,
                                torch.zeros_like(Q))
                he = torch.as_tensor(rng.normal(size=(G, B, n)).astype(np.float32), device=dev)
                nnz = pt_wide_cuda.group_nnz(pt_wide_cuda.row_nnz(split_qubo(Q)[1]))
                share = max(nnz) / n**2
                smem = wide_cuda.sparse_smem_bytes(n, C, pt_wide_cuda.padded(max(nnz)))
                label = f"n={n} chains={chains} density {density}"
                if smem > kernel_call.SMEM_BYTES:
                    records[label] = {"share": share, "sparse_smem": smem, "fits": False}
                    print(f"sparse_density {label}: J_g {share:.4f} nonzeros, the row lists "
                          f"need {smem} bytes beside {C} chains: they do not fit", flush=True)
                    continue
                for kernel, rule in (("Metropolis", wide_cuda.METROPOLIS),
                                     ("pair", wide_cuda.PAIR)):
                    J, h, hot, logr = anneal_form(Q, he, S, rule)
                    run = shared_paths(J, h, hot, logr, R, S, rule, gen)
                    dense_ms, sparse_ms = turns(run[wide_cuda.DENSE], run[wide_cuda.SPARSE], runs)
                    records[f"K4 {kernel}, {label}"] = {
                        "share": share, "fits": True, "dense_ms": dense_ms,
                        "sparse_ms": sparse_ms, "rule_path": wide_cuda.shared_path(nnz, n, C)}
                    print(f"sparse_density K4 {kernel} {label} (G={G} B={B} R={R} S={S}, {C} "
                          f"chains a block): J_g {share:.4f} nonzeros; dense path "
                          f"{dense_ms[0]:.3f} / {dense_ms[1]:.3f} ms, sparse path "
                          f"{sparse_ms[0]:.3f} / {sparse_ms[1]:.3f} ms (turns dense sparse "
                          f"sparse dense, median of {runs}); the rule (SHARED_SPARSE_DENSITY "
                          f"{wide_cuda.SHARED_SPARSE_DENSITY}) takes the "
                          f"{wide_cuda.shared_path(nnz, n, C)} path", flush=True)
                del Q, he, keep
    return records


def build_clocks() -> ctypes.CDLL:
    """The sparse path built with -DQBMX_K4S_CLOCKS into
    ``build/kernels_k4s_clocks/``, by this tree's C interface."""
    compile_, link = build("kernels_k4s_clocks", [_build.CSRC / "anneal_wide_sparse.cu"],
                           ("-DQBMX_K4S_CLOCKS",))
    _build._run_all(compile_)
    _build._run_all([link])
    lib = ctypes.CDLL(link[link.index("-o") + 1])
    lib.qbmx_anneal_wide_sparse.argtypes = _build.load_kernels().qbmx_anneal_wide_sparse.argtypes
    lib.qbmx_anneal_wide_sparse.restype = ctypes.c_int
    lib.qbmx_anneal_wide_sparse_clocks.argtypes = [ctypes.c_void_p]
    lib.qbmx_anneal_wide_sparse_clocks.restype = ctypes.c_int
    return lib


def lib_sparse(lib, J, h, hot, logr, R, S, rule, out):
    """The sparse path from another build of its source, Philox mode, on
    the rule's chains a block; returns a launch."""
    G, B, n = h.shape
    rows = pt_wide_cuda.row_lists(J)
    units = wide_cuda.unit_couplings(J)
    C = wide_cuda.wide_geometry(G, B, R, n).chains_per_block
    return lambda: kernel_call.check_rc("anneal_wide_sparse", lib.qbmx_anneal_wide_sparse(
        rows.vals.data_ptr(), rows.cols.data_ptr(), rows.offsets.data_ptr(), units.data_ptr(),
        h.data_ptr(), hot.data_ptr(), logr.data_ptr(), None, None, out.data_ptr(), None, None,
        rows.nnz_pad, G, B, R, n, S, ctypes.c_float(sa_torch.inv_span(S)), 7, rule, C,
        kernel_call.stream(h.device)))


def time_sparse_split(runs: int, dev) -> dict:
    """The sparse path's time by part at ``shared_calls``, S=1000: the
    clocks build's cycles of each part summed over the chains, their
    shares, and those shares of the main build's median time."""
    lib = build_clocks()
    R, S = 100, 1000
    gen = lambda: torch.Generator().manual_seed(7)
    records = {}
    for label, (Q, he) in shared_calls(dev).items():
        G, B, n = he.shape
        for kernel, rule in (("Metropolis", wide_cuda.METROPOLIS), ("pair", wide_cuda.PAIR)):
            J, h, hot, logr = anneal_form(Q, he, S, rule)
            whole_ms = median_ms(shared_paths(J, h, hot, logr, R, S, rule, gen)[wide_cuda.SPARSE],
                                 runs)
            clocked = lib_sparse(lib, J, h, hot, logr, R, S, rule,
                                 torch.empty((G, B, R, n), device=dev))
            cycles = (ctypes.c_ulonglong * len(CLOCK_PARTS))()
            clocked()  # a warm-up, then one counted launch
            torch.cuda.synchronize()
            kernel_call.check_rc("clocks", lib.qbmx_anneal_wide_sparse_clocks(cycles))
            clocked_ms = median_ms(clocked, 1)  # the warm-up launch, then the timed one
            torch.cuda.synchronize()
            kernel_call.check_rc("clocks", lib.qbmx_anneal_wide_sparse_clocks(cycles))
            total = sum(cycles) / 2  # the two launches median_ms made
            shares = {part: cycles[k] / 2 / total for k, part in enumerate(CLOCK_PARTS)}
            rec = {"whole_ms": whole_ms, "clocked_ms": clocked_ms, "shares": shares,
                   "ms": {part: whole_ms * v for part, v in shares.items()},
                   "cycles_a_chain": total / (G * B * R)}
            records[f"K4 {kernel}, {label}"] = rec
            print(f"sparse_split K4 {kernel} {label} S={S}: sparse path {whole_ms:.3f} ms "
                  f"(clocked build {clocked_ms:.3f} ms) = "
                  + ", ".join(f"{part} {shares[part]:.3f} ({rec['ms'][part]:.3f} ms)"
                              for part in CLOCK_PARTS)
                  + f" of {rec['cycles_a_chain']:.4g} cycles a chain (each chain's lane 0, "
                  "clock64)", flush=True)
    return records


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path,
                    help=f"qbmx_torch/csrc directory of commit 492df98 (parts {OLD_PARTS})")
    ap.add_argument("--parent", type=Path,
                    help=f"qbmx_torch/csrc directory of commit {PARENT} (parts {PARENT_PARTS})")
    ap.add_argument("--pt_parent", type=Path,
                    help=f"qbmx_torch/csrc directory of commit {PT_PARENT} (part pt_parent)")
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--parts", nargs="+", choices=PARTS, default=list(PARTS))
    args = ap.parse_args(argv)
    for flag, needed in (("old", OLD_PARTS), ("parent", PARENT_PARTS),
                         ("pt_parent", ("pt_parent",))):
        if getattr(args, flag) is None and set(needed) & set(args.parts):
            ap.error(f"--{flag} is needed for the parts {sorted(set(needed) & set(args.parts))}")
    if not torch.cuda.is_available():
        raise SystemExit("compare_kernels: needs a CUDA GPU")
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain version in full float32
    old = refresh1 = None
    if set(OLD_PARTS) & set(args.parts):
        old, refresh1 = build_libs(args.old)
    _build.load_kernels()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    for part, run in (("k5", lambda: time_k5(old, args.runs, dev)),
                      ("k4", lambda: time_k4(old, args.runs, dev)),
                      ("layouts", lambda: time_layouts(args.runs, dev)),
                      ("pt_layouts", lambda: time_pt_layouts(args.runs, dev)),
                      ("pt_parent", lambda: time_pt_parent(args.pt_parent, args.runs, dev)),
                      ("k4_agreement", lambda: k4_agreement(refresh1, dev)),
                      ("split", lambda: time_split(build_split(args.parent, SPLIT_PATCH, PARENT),
                                                   True, args.runs, dev)),
                      ("global", lambda: time_global(args.parent, args.runs, dev)),
                      ("density", lambda: time_density(args.runs, dev)),
                      ("split_new", lambda: time_split(
                          build_split(_build.CSRC, SPLIT_PATCH_NEW, "this tree"), False,
                          args.runs, dev)),
                      ("sparse_shared", lambda: time_sparse_shared(args.runs, dev)),
                      ("sparse_density", lambda: time_sparse_density(args.runs, dev)),
                      ("sparse_split", lambda: time_sparse_split(args.runs, dev))):
        if part in args.parts:
            result[part] = run()
    print(smi)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
