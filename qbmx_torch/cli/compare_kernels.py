"""Time the heat-bath kernel K2 (``sa_heatbath.cu``), the tempering
kernel K3 (``pt_heatbath.cu``) and the wide anneal K4 (``anneal_wide.cu``)
of this tree against their sources at commit 64a1153 (one thread a chain,
one thread a ladder; K4 as it was before its tiles moved into
``anneal_tiles.cuh``, the code it shares with K5), on one GPU, in one
process, in turns (old, new, new, old).

    mkdir -p build/old && git archive 64a1153 qbmx_torch/csrc | tar -x -C build/old
    python -m qbmx_torch.cli.compare_kernels --old build/old/qbmx_torch/csrc

The old library is declared with that commit's C interface (no layout
argument, no optional outputs), so the tool compares against 64a1153's
sources only; they are built with the same ``nvcc`` flags into
``build/kernels_old/``.  Four parts, all on random QUBOs from numpy seeds:

1. old against new, in Philox mode: K2 pair at the CDQBM default call
   (G=2, B=3, n=41, R=100, S=1000) and at the flagship structured call
   (G=2, B=60, n=6, R=1000, S=1000), K2 single and quad at the dense bench
   shape (B=60 groups of one, n=41, R=100, S=1000), K3 at the flagship PT
   call (120 problems, n=6, M=8, R=1000, S=1000) and at the flat CLI
   defaults' (146 problems, n=3, M=8, R=100, S=1000), K4 Metropolis and
   pair at the CDQBM (a) call (G=2, B=20, n=717, R=100, S=1000); and K1 at its two
   main-path shapes, the same code on both sides (a control of the spread
   between turns).  Each turn is the median of ``--runs`` CUDA-event
   timings after a warm-up; each new K1 and K2 launch also counts its
   flips once, for the bound (``qbmx_torch.utils.roofline``).
2. K1's and K2's two layouts, each forced, on either side of
   ``kernel_call.chain_layout``'s one rule at n = 6: the flagship call
   (120,000 chains: a thread a chain is chosen) and the CDQBM default
   call's shape at n = 6 (600 chains: a warp a chain), in turns (thread,
   warp, warp, thread); K3's two layouts, each forced, at the flagship PT
   call (a rung a thread is chosen), in turns (rung, warp, warp, rung).
3. Agreement with the plain version on host variates at the CDQBM
   default call (K2, each width, S=300; three seeds): the fraction of
   chains that end in another state than the plain version's, for the
   old K2 (a dot product a field) and this K2 (incremental fields).
4. K4's agreement at ``tests/test_torch_cuda.py``'s deep shape (n = 301,
   S = 70, heat-bath at beta 1.5; G=1, B=4, R=500, three seeds), this K4
   against this K4 built with ``-DQBMX_K4_REFRESH_PERIOD=1`` (into
   ``build/kernels_refresh1/``: every field recomputed just before its
   decision), each against plain and against each other.

Prints one line per measurement, the ``nvidia-smi`` name and power limit,
and last one JSON object with every number.
"""

from __future__ import annotations

import argparse
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
from qbmx_torch.samplers import (gibbs, gibbs_cuda, kernel_call, pt_cuda, sa_cuda, sa_torch,
                                 tempering, wide_cuda)
from qbmx_torch.utils.roofline import anneal_bound, heatbath_units

SHAPES = {  # label: (kernel, width, G, B, n, R, S); K3: (B, M) in (G, B), problems G
    "K2 pair CDQBM (b) G=2 B=3 n=41 R=100 S=1000": ("K2", 2, 2, 3, 41, 100, 1000),
    "K2 pair flagship G=2 B=60 n=6 R=1000 S=1000": ("K2", 2, 2, 60, 6, 1000, 1000),
    "K2 single dense bench B=60 n=41 R=100 S=1000": ("K2", 1, 60, 1, 41, 100, 1000),
    "K2 quad dense bench B=60 n=41 R=100 S=1000": ("K2", 4, 60, 1, 41, 100, 1000),
    "K3 flagship B=120 n=6 M=8 R=1000 S=1000": ("K3", 1, 120, 8, 6, 1000, 1000),
    "K3 CLI defaults B=146 n=3 M=8 R=100 S=1000": ("K3", 1, 146, 8, 3, 100, 1000),
    "K4 Metropolis CDQBM (a) G=2 B=20 n=717 R=100 S=1000": ("K4", 0, 2, 20, 717, 100, 1000),
    "K4 pair CDQBM (a) G=2 B=20 n=717 R=100 S=1000": ("K4", 2, 2, 20, 717, 100, 1000),
    "K1 flagship G=2 B=60 n=6 R=1000 S=1000 (control)": ("K1", 0, 2, 60, 6, 1000, 1000),
    "K1 CDQBM (b) G=2 B=3 n=41 R=100 S=1000 (control)": ("K1", 0, 2, 3, 41, 100, 1000),
}
LAYOUT_SHAPES = {  # label: (G, B, n, R, S)
    "flagship G=2 B=60 n=6 R=1000 S=1000": (2, 60, 6, 1000, 1000),
    "few chains G=2 B=3 n=6 R=100 S=1000": (2, 3, 6, 100, 1000),
}
K2_AGREE = dict(G=2, B=3, n=41, R=100, S=300, seeds=(0, 1, 2))
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
    """The old K2, K3 and K4, and this K4 refreshing its fields every sweep."""
    jobs = [build("kernels_old", [old_csrc / "sa_heatbath.cu", old_csrc / "pt_heatbath.cu",
                                  old_csrc / "anneal_wide.cu"]),
            build("kernels_refresh1", [_build.CSRC / "anneal_wide.cu"],
                  ("-DQBMX_K4_REFRESH_PERIOD=1",))]
    _build._run_all([c for compile_, _ in jobs for c in compile_])
    _build._run_all([link for _, link in jobs])
    old, refresh1 = (ctypes.CDLL(link[link.index("-o") + 1]) for _, link in jobs)
    p, i, f, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_ulonglong
    old.qbmx_sa_heatbath.argtypes = [p] * 7 + [i] * 5 + [f, u64, i, p]
    old.qbmx_pt_heatbath.argtypes = [p] * 8 + [i] * 5 + [u64, p]
    for lib in (old, refresh1):  # K4's C interface is the same on both sides
        lib.qbmx_anneal_wide.argtypes = [p] * 9 + [i] * 5 + [f, u64, i, i, p]
    for fn in (old.qbmx_sa_heatbath, old.qbmx_pt_heatbath, old.qbmx_anneal_wide,
               refresh1.qbmx_anneal_wide):
        fn.restype = i
    return old, refresh1


def problem(rng, width, G, B, n, S, dev, beta=1.0):
    """(Q, h_extra) random QUBOs and (J, h, hot, logr) scheduled as the
    wrappers do: Metropolis at width 0, heat-bath at ``beta`` otherwise."""
    Q = random_qubo_batch(rng, G, n).to(dev)
    h_extra = torch.as_tensor(rng.normal(size=(G, B, n)).astype(np.float32), device=dev)
    hs, J = split_qubo(Q)
    h = (hs[:, None, :] + h_extra).contiguous()
    if width == 0:
        hot, logr = sa_torch.schedule_params(h, J[:, None], S)
    else:
        hot, logr = gibbs.heat_bath_schedule(h, J[:, None], S, beta)
    return (Q, h_extra), (J.contiguous(), h, hot, logr)


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


def old_k2(old, J, h, hot, logr, R, S, width, out, seed=7, init01=None, uniforms=None):
    G, B, n = h.shape
    kernel_call.check_rc("old sa_heatbath", old.qbmx_sa_heatbath(
        J.data_ptr(), h.data_ptr(), hot.data_ptr(), logr.data_ptr(),
        None if init01 is None else init01.data_ptr(),
        None if uniforms is None else uniforms.data_ptr(), out.data_ptr(), G, B, R, n, S,
        ctypes.c_float(sa_torch.inv_span(S)), seed, width, kernel_call.stream(h.device)))
    return out


def lib_k4(lib, J, h, hot, logr, R, S, rule, out, seed=7, init01=None, uniforms=None):
    """K4 from another build of its source, by the C interface they share."""
    G, B, n = h.shape
    Jp = F.pad(J, (0, wide_cuda.row_floats(n) - n)).contiguous()
    kernel_call.check_rc("anneal_wide", lib.qbmx_anneal_wide(
        Jp.data_ptr(), h.data_ptr(), hot.data_ptr(), logr.data_ptr(),
        None if init01 is None else init01.data_ptr(),
        None if uniforms is None else uniforms.data_ptr(), out.data_ptr(), None, None,
        G, B, R, n, S, ctypes.c_float(sa_torch.inv_span(S)), seed, rule,
        wide_cuda.wide_geometry(G, B, R, n).chains_per_block, kernel_call.stream(h.device)))
    return out


def time_old_new(old, runs, dev) -> dict:
    records = {}
    rng = np.random.default_rng(2024)
    gen = lambda: torch.Generator().manual_seed(7)
    for label, (kernel, width, G, B, n, R, S) in SHAPES.items():
        counted = None
        if kernel == "K3":
            Q = random_qubo_batch(rng, G, n).to(dev)
            h, J = (t.contiguous() for t in split_qubo(Q))
            betas, dbeta = tempering.ladder_betas(Q, B, 1.0)
            out = torch.empty((G, R, n), device=dev)
            run_old = lambda: kernel_call.check_rc("old pt_heatbath", old.qbmx_pt_heatbath(
                J.data_ptr(), h.data_ptr(), betas.data_ptr(), dbeta.data_ptr(), None, None, None,
                out.data_ptr(), G, B, R, n, S, 7, kernel_call.stream(dev)))
            run_new = lambda: pt_cuda.pt_sample_batch_cuda(Q, R, S, num_replicas=B, generator=gen())
            bound = anneal_bound(G, 1, R, n, S, decisions=G * B * R * n * S)
            geometry = pt_cuda.pt_layout(G, B, R, n)
        else:
            _, (J, h, hot, logr) = problem(rng, width, G, B, n, S, dev)
            out = torch.empty((G, B, R, n), device=dev)
            geometry = kernel_call.chain_layout(G, B, R, n) if kernel != "K4" else \
                wide_cuda.wide_geometry(G, B, R, n)
            if kernel == "K2":
                run_old = lambda: old_k2(old, J, h, hot, logr, R, S, width, out)
                run_new = lambda **kw: gibbs_cuda.launch(J, h, hot, logr, R, S, width,
                                                         generator=gen(), **kw)
            elif kernel == "K4":
                run_old = lambda: lib_k4(old, J, h, hot, logr, R, S, width, out)
                run_new = lambda **kw: wide_cuda.launch(J, h, hot, logr, R, S, width,
                                                        generator=gen(), **kw)
            else:  # K1, the same code on both sides
                run_old = run_new = lambda **kw: sa_cuda.launch(J, h, hot, logr, R, S,
                                                                generator=gen(), **kw)
            flips = torch.zeros(1, dtype=torch.int64, device=dev)
            run_new(flips=flips)
            torch.cuda.synchronize()
            counted = int(flips.item())
            units = n if width == 0 else heatbath_units(n, width)
            bound = anneal_bound(G, B, R, n, S, decisions=G * B * R * units * S, flips=counted)
        old_ms, new_ms = turns(run_old, run_new, runs)
        records[label] = {"old_ms": old_ms, "new_ms": new_ms, "flips": counted,
                          "geometry": str(geometry), **bound}
        print(f"{label}: old {old_ms[0]:.3f} / {old_ms[1]:.3f} ms, new {new_ms[0]:.3f} / "
              f"{new_ms[1]:.3f} ms (CUDA events, median of {runs} each, turns old new new "
              f"old); flips {counted}; bound {bound['bound_ms']:.4f} ms by {bound['bound_by']}; "
              f"{geometry}", flush=True)
    return records


def time_layouts(runs, dev) -> dict:
    records = {}
    gen = lambda: torch.Generator().manual_seed(7)
    for label, (G, B, n, R, S) in LAYOUT_SHAPES.items():
        chosen = kernel_call.chain_layout(G, B, R, n).lanes
        for kernel, width in (("K1", 0), ("K2 pair", 2)):
            _, (J, h, hot, logr) = problem(np.random.default_rng(2024), width, G, B, n, S, dev)
            if width == 0:
                run = {lanes: (lambda lanes=lanes: sa_cuda.launch(
                    J, h, hot, logr, R, S, lanes=lanes, generator=gen())) for lanes in (1, 32)}
            else:
                run = {lanes: (lambda lanes=lanes: gibbs_cuda.launch(
                    J, h, hot, logr, R, S, width, lanes=lanes, generator=gen()))
                    for lanes in (1, 32)}
            thread_ms, warp_ms = turns(run[1], run[32], runs)
            records[f"{kernel} {label}"] = {"thread_ms": thread_ms, "warp_ms": warp_ms,
                                            "chosen_lanes": chosen}
            print(f"{kernel} {label}: a thread a chain {thread_ms[0]:.3f} / {thread_ms[1]:.3f} ms, "
                  f"a warp a chain {warp_ms[0]:.3f} / {warp_ms[1]:.3f} ms (CUDA events, median of "
                  f"{runs} each, turns thread warp warp thread); chain_layout chooses {chosen} "
                  "lanes", flush=True)
    B, M, n, R, S = 120, 8, 6, 1000, 1000
    Q = random_qubo_batch(np.random.default_rng(2024), B, n).to(dev)
    run = {kind: (lambda kind=kind: pt_cuda.pt_sample_batch_cuda(
        Q, R, S, num_replicas=M, generator=gen(), _layout=kind))
        for kind in (pt_cuda.RUNG, pt_cuda.WARP)}
    rung_ms, warp_ms = turns(run[pt_cuda.RUNG], run[pt_cuda.WARP], runs)
    chosen = pt_cuda.pt_layout(B, M, R, n).kind
    label = f"K3 flagship B={B} n={n} M={M} R={R} S={S}"
    records[label] = {"rung_ms": rung_ms, "warp_ms": warp_ms, "chosen_kind": chosen}
    print(f"{label}: a rung a thread {rung_ms[0]:.3f} / {rung_ms[1]:.3f} ms, a rung a warp "
          f"{warp_ms[0]:.3f} / {warp_ms[1]:.3f} ms (CUDA events, median of {runs} each, turns "
          f"rung warp warp rung); pt_layout chooses {'RUNG' if chosen == pt_cuda.RUNG else 'WARP'}",
          flush=True)
    return records


def k2_agreement(old, dev) -> dict:
    G, B, n, R, S = (K2_AGREE[k] for k in ("G", "B", "n", "R", "S"))
    records = {}
    for width, kw in ((1, {}), (2, dict(pair=True)), (4, dict(quad=True))):
        counts = {"old": 0.0, "new": 0.0}
        for seed in K2_AGREE["seeds"]:
            rng = np.random.default_rng(500 + seed)
            (Q, h_extra), (J, h, hot, logr) = problem(rng, width, G, B, n, S, dev)
            init01 = torch.as_tensor((rng.random((G, B, R, n)) < 0.5).astype(np.float32),
                                     device=dev)
            u = torch.as_tensor(np.clip(rng.random((S, G, B, n, R)), 1e-6, 1 - 1e-6)
                                .astype(np.float32), device=dev)
            plain = gibbs.gibbs_sample_groups_plain(Q, h_extra, R, S, host_variates=(init01, u),
                                                    **kw)
            new = gibbs_cuda.launch(J, h, hot, logr, R, S, width, host_variates=(init01, u))
            out_old = old_k2(old, J, h, hot, logr, R, S, width, torch.empty_like(new), 0, init01, u)
            torch.cuda.synchronize()
            counts["old"] += differ(out_old, plain) / len(K2_AGREE["seeds"])
            counts["new"] += differ(new, plain) / len(K2_AGREE["seeds"])
        records[f"width {width}"] = counts
        print(f"K2 agreement width {width} G={G} B={B} n={n} R={R} S={S}, "
              f"{len(K2_AGREE['seeds'])} seeds: chains differing from plain: old K2 "
              f"{counts['old']:.5f}, new K2 {counts['new']:.5f}", flush=True)
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


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, required=True,
                    help="qbmx_torch/csrc directory of commit 64a1153")
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("compare_kernels: needs a CUDA GPU")
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain version in full float32
    old, refresh1 = build_libs(args.old)
    _build.load_kernels()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "records": time_old_new(old, args.runs, dev),
              "layouts": time_layouts(args.runs, dev),
              "k2_agreement": k2_agreement(old, dev),
              "k4_agreement": k4_agreement(refresh1, dev)}
    print(smi)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
