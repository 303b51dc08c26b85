"""Time the parallel-tempering kernel K5 (``pt_wide.cu``) and the wide
anneal K4 (``anneal_wide.cu``) of this tree against their sources at the
parent commit 492df98 (K5 streaming J_g in tiles, whole ladders a block;
K4 before its per-row work counter), on one GPU, in one process, in turns
(old, new, new, old).

    mkdir -p build/old && git archive 492df98 qbmx_torch/csrc | tar -x -C build/old
    python -m qbmx_torch.cli.compare_kernels --old build/old/qbmx_torch/csrc

The old library is declared with that commit's C interface, so the tool
compares against 492df98's sources only; they are built with the same
``nvcc`` flags into ``build/kernels_old/``.  Parts (``--parts``, all by
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
* ``layouts``: K1's and K2's two layouts, each forced, on either side of
  ``kernel_call.chain_layout``'s one rule at n = 6 (the flagship call, and
  600 chains), and K3's two layouts at the flagship PT call, in turns;
* ``k4_agreement``: K4's agreement with plain at ``tests/test_torch_cuda.py``'s
  deep shape (n = 301, S = 70, heat-bath at beta 1.5; G=1, B=4, R=500,
  three seeds), this K4 against this K4 built with
  ``-DQBMX_K4_REFRESH_PERIOD=1`` (into ``build/kernels_refresh1/``: every
  field recomputed just before its decision).

Each turn is the median of ``--runs`` CUDA-event timings after a warm-up.
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
from qbmx_torch.models.cdqbm import cdqbm_a_qubos
from qbmx_torch.samplers import (gibbs, gibbs_cuda, kernel_call, pt_cuda, pt_wide_cuda, sa_cuda,
                                 sa_torch, wide_cuda)
from qbmx_torch.utils.roofline import anneal_bound, heatbath_units

PARTS = ("k5", "k4", "layouts", "k4_agreement")
K5_CALL = dict(G=2, B=20, M=8, R=100, n=717)  # the CDQBM (a) PT call
K4_SHAPES = {  # label: (rule, G, B, n, R, S)
    "K4 Metropolis CDQBM (a) G=2 B=20 n=717 R=100 S=1000": (0, 2, 20, 717, 100, 1000),
    "K4 pair CDQBM (a) G=2 B=20 n=717 R=100 S=1000": (2, 2, 20, 717, 100, 1000),
}
LAYOUT_SHAPES = {  # label: (G, B, n, R, S)
    "flagship G=2 B=60 n=6 R=1000 S=1000": (2, 60, 6, 1000, 1000),
    "few chains G=2 B=3 n=6 R=100 S=1000": (2, 3, 6, 100, 1000),
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
                    help="qbmx_torch/csrc directory of commit 492df98")
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--parts", nargs="+", choices=PARTS, default=list(PARTS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("compare_kernels: needs a CUDA GPU")
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain version in full float32
    old, refresh1 = build_libs(args.old)
    _build.load_kernels()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    for part, run in (("k5", lambda: time_k5(old, args.runs, dev)),
                      ("k4", lambda: time_k4(old, args.runs, dev)),
                      ("layouts", lambda: time_layouts(args.runs, dev)),
                      ("k4_agreement", lambda: k4_agreement(refresh1, dev))):
        if part in args.parts:
            result[part] = run()
    print(smi)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
