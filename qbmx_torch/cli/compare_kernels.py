"""Time the anneal kernels K1 (``sa_metropolis.cu``) and K4
(``anneal_wide.cu``) of this tree against their sources at commit 76a7f1b,
on one GPU, in one process, in turns (old, new, new, old).

    mkdir -p build/old && git archive 76a7f1b qbmx_torch/csrc | tar -x -C build/old
    python -m qbmx_torch.cli.compare_kernels --old build/old/qbmx_torch/csrc

The old library is declared with that commit's C interface (no layout,
geometry or optional outputs), so the tool compares against 76a7f1b's
sources only; they are built with the same ``nvcc`` flags into
``build/kernels_old/``.  Three parts, all on random QUBOs from numpy seeds:

1. old against new, in Philox mode: K4 Metropolis and pair at the CDQBM
   probabilistic-pooling call (G=2, B=20, n=717, R=100, S=1000), K1 at the
   flagship structured call (G=2, B=60, n=6, R=1000, S=1000), the dense
   bench shape (B=60 groups of one, n=41, R=100, S=1000) and the CDQBM
   default call (G=2, B=3, n=41, R=100, S=1000).  Each turn is the median
   of ``--runs`` CUDA-event timings after a warm-up; each new kernel also
   counts its flips once, for the bound (``qbmx_torch.utils.roofline``).
2. K1's two layouts, each forced, on either side of ``sa_cuda.k1_layout``'s
   rule at n = 6: the flagship call (120,000 chains: a thread a chain is
   chosen) and the CDQBM default call's shape at n = 6 (600 chains: a warp
   a chain), in turns (thread, warp, warp, thread).
3. Agreement with the plain version on host variates, for each rule of K4,
   at ``tests/test_torch_cuda.py``'s deep shape (n = 301, S = 70, heat-bath
   at beta 1.5; G=1, B=4, R=500, three seeds): the fraction of chains that
   end in another state than the plain version's, for the old K4 (a full
   dot product a decision), this K4, and this K4 built with
   ``-DQBMX_K4_REFRESH_PERIOD=1`` (into ``build/kernels_refresh1/``: every
   field recomputed just before its decision, so no incremental update
   reaches a decision), and between this K4 and that build.

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
from qbmx_torch.samplers import gibbs, kernel_call, sa_cuda, sa_torch, wide_cuda
from qbmx_torch.utils.roofline import anneal_bound

SHAPES = {  # label: (kernel, rule, G, B, n, R, S)
    "K4 Metropolis G=2 B=20 n=717 R=100 S=1000": ("K4", 0, 2, 20, 717, 100, 1000),
    "K4 pair G=2 B=20 n=717 R=100 S=1000": ("K4", 2, 2, 20, 717, 100, 1000),
    "K1 flagship G=2 B=60 n=6 R=1000 S=1000": ("K1", 0, 2, 60, 6, 1000, 1000),
    "K1 dense bench B=60 n=41 R=100 S=1000": ("K1", 0, 60, 1, 41, 100, 1000),
    "K1 CDQBM (b) G=2 B=3 n=41 R=100 S=1000": ("K1", 0, 2, 3, 41, 100, 1000),
}
LAYOUT_SHAPES = {  # label: (G, B, n, R, S)
    "K1 flagship G=2 B=60 n=6 R=1000 S=1000": (2, 60, 6, 1000, 1000),
    "K1 few chains G=2 B=3 n=6 R=100 S=1000": (2, 3, 6, 100, 1000),
}
AGREE = dict(G=1, B=4, n=301, R=500, S=70, beta=1.5, seeds=(0, 1, 2))
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
    """The old K1 and K4, and this K4 refreshing its fields every sweep."""
    jobs = [build("kernels_old", [old_csrc / "sa_metropolis.cu", old_csrc / "anneal_wide.cu"]),
            build("kernels_refresh1", [_build.CSRC / "anneal_wide.cu"],
                  ("-DQBMX_K4_REFRESH_PERIOD=1",))]
    _build._run_all([c for compile_, _ in jobs for c in compile_])
    _build._run_all([link for _, link in jobs])
    old, refresh1 = (ctypes.CDLL(link[link.index("-o") + 1]) for _, link in jobs)
    p, i, f, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_ulonglong
    old.qbmx_sa_metropolis.argtypes = [p] * 7 + [i] * 5 + [f, u64, p]
    old.qbmx_anneal_wide.argtypes = [p] * 7 + [i] * 5 + [f, u64, i, p]
    refresh1.qbmx_anneal_wide.argtypes = [p] * 9 + [i] * 5 + [f, u64, i, i, p]
    for fn in (old.qbmx_sa_metropolis, old.qbmx_anneal_wide, refresh1.qbmx_anneal_wide):
        fn.restype = i
    return old, refresh1


def problem(rng, rule, G, B, n, S, dev, beta=1.0):
    """(Q, h_extra) random QUBOs and (J, h, hot, logr) scheduled as the wrappers do."""
    Q = random_qubo_batch(rng, G, n).to(dev)
    h_extra = torch.as_tensor(rng.normal(size=(G, B, n)).astype(np.float32), device=dev)
    hs, J = split_qubo(Q)
    h = (hs[:, None, :] + h_extra).contiguous()
    if rule == wide_cuda.METROPOLIS:
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


def differ(a, b) -> float:
    return (a != b).reshape(-1, a.shape[-1]).any(dim=1).double().mean().item()


def time_old_new(old, runs, dev) -> dict:
    records = {}
    rng = np.random.default_rng(2024)
    for label, (kernel, rule, G, B, n, R, S) in SHAPES.items():
        _, (J, h, hot, logr) = problem(rng, rule, G, B, n, S, dev)
        out = torch.empty((G, B, R, n), device=dev)
        span = ctypes.c_float(sa_torch.inv_span(S))
        st = kernel_call.stream(dev)
        ptrs = (J.data_ptr(), h.data_ptr(), hot.data_ptr(), logr.data_ptr(), None, None)
        if kernel == "K4":
            run_old = lambda: kernel_call.check_rc("old anneal_wide", old.qbmx_anneal_wide(
                *ptrs, out.data_ptr(), G, B, R, n, S, span, 7, rule, st))
            run_new = lambda **kw: wide_cuda.launch(J, h, hot, logr, R, S, rule,
                                                    generator=torch.Generator().manual_seed(7), **kw)
        else:
            run_old = lambda: kernel_call.check_rc("old sa_metropolis", old.qbmx_sa_metropolis(
                *ptrs, out.data_ptr(), G, B, R, n, S, span, 7, st))
            run_new = lambda **kw: sa_cuda.launch(J, h, hot, logr, R, S,
                                                  generator=torch.Generator().manual_seed(7), **kw)
        turns = [median_ms(run_old, runs), median_ms(run_new, runs),
                 median_ms(run_new, runs), median_ms(run_old, runs)]
        flips = torch.zeros(1, dtype=torch.int64, device=dev)
        run_new(flips=flips)
        torch.cuda.synchronize()
        units = -(-n // 2) if rule == wide_cuda.PAIR else n  # a pair draws once
        bound = anneal_bound(G, B, R, n, S, decisions=G * B * R * units * S,
                             flips=int(flips.item()))
        geometry = (wide_cuda.wide_geometry(G, B, R, n) if kernel == "K4"
                    else sa_cuda.k1_layout(G, B, R, n))
        records[label] = {"old_ms": [turns[0], turns[3]], "new_ms": [turns[1], turns[2]],
                          "flips": int(flips.item()), "flip_rate": flips.item() / (G * B * R * n * S),
                          "geometry": str(geometry), **bound}
        print(f"{label}: old {turns[0]:.3f} / {turns[3]:.3f} ms, new {turns[1]:.3f} / "
              f"{turns[2]:.3f} ms (CUDA events, median of {runs} each, turns old new new "
              f"old); flips {flips.item()} (rate {records[label]['flip_rate']:.4f}); bound "
              f"{bound['bound_ms']:.3f} ms by {bound['bound_by']}; {geometry}", flush=True)
    return records


def time_layouts(runs, dev) -> dict:
    records = {}
    for label, (G, B, n, R, S) in LAYOUT_SHAPES.items():
        _, (J, h, hot, logr) = problem(np.random.default_rng(2024), 0, G, B, n, S, dev)
        run = {lanes: (lambda lanes=lanes: sa_cuda.launch(
            J, h, hot, logr, R, S, lanes=lanes, generator=torch.Generator().manual_seed(7)))
            for lanes in (1, 32)}
        turns = [median_ms(run[1], runs), median_ms(run[32], runs), median_ms(run[32], runs),
                 median_ms(run[1], runs)]
        chosen = sa_cuda.k1_layout(G, B, R, n).lanes
        records[label] = {"thread_ms": [turns[0], turns[3]], "warp_ms": [turns[1], turns[2]],
                          "chosen_lanes": chosen}
        print(f"{label}: a thread a chain {turns[0]:.3f} / {turns[3]:.3f} ms, a warp a chain "
              f"{turns[1]:.3f} / {turns[2]:.3f} ms (CUDA events, median of {runs} each, turns "
              f"thread warp warp thread); k1_layout chooses {chosen} lanes", flush=True)
    return records


def agreement(old, refresh1, dev) -> dict:
    G, B, n, R, S, beta = (AGREE[k] for k in ("G", "B", "n", "R", "S", "beta"))
    span, st = ctypes.c_float(sa_torch.inv_span(S)), kernel_call.stream(dev)
    geo = wide_cuda.wide_geometry(G, B, R, n)
    records = {}
    for name, rule in RULES.items():
        counts = {"old": 0.0, "new": 0.0, "refresh1": 0.0, "new vs refresh1": 0.0}
        for seed in AGREE["seeds"]:
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
            out_old, out_r1 = torch.empty_like(new), torch.empty_like(new)
            ptrs = (h.data_ptr(), hot.data_ptr(), logr.data_ptr(), init01.data_ptr(), u.data_ptr())
            kernel_call.check_rc("old anneal_wide", old.qbmx_anneal_wide(
                J.data_ptr(), *ptrs, out_old.data_ptr(), G, B, R, n, S, span, 0, rule, st))
            Jp = F.pad(J, (0, wide_cuda.row_floats(n) - n)).contiguous()
            kernel_call.check_rc("anneal_wide refresh 1", refresh1.qbmx_anneal_wide(
                Jp.data_ptr(), *ptrs, out_r1.data_ptr(), None, None, G, B, R, n, S, span, 0, rule,
                geo.chains_per_block, st))
            torch.cuda.synchronize()
            for key, a, b in (("old", out_old, plain), ("new", new, plain),
                              ("refresh1", out_r1, plain), ("new vs refresh1", new, out_r1)):
                counts[key] += differ(a, b) / len(AGREE["seeds"])
        records[name] = counts
        print(f"agreement {name} G={G} B={B} n={n} R={R} S={S} (beta {beta}), "
              f"{len(AGREE['seeds'])} seeds: chains differing from plain: old K4 "
              f"{counts['old']:.5f}, new K4 {counts['new']:.5f}, new K4 refreshed every "
              f"sweep {counts['refresh1']:.5f}; new vs refreshed every sweep "
              f"{counts['new vs refresh1']:.5f}", flush=True)
    return records


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, required=True,
                    help="qbmx_torch/csrc directory of commit 76a7f1b")
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
              "agreement": agreement(old, refresh1, dev)}
    print(smi)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
