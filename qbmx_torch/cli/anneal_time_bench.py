"""Sampler time against QBM size for each backend (the counterpart of
``scripts/anneal_time_bench.py``, the reference's
``anneal_time_per_qbm_size`` figure).

For each size n: one shared-coupling QUBO (``random_qubo_batch``) and
``--batch`` per-problem linear terms, drawn from ``--seed``, densified for
the dense columns so that every column anneals the same problems.  The
columns are the script's, mapped to the port's solvers: ``SA`` (K1 up to
n = 241, K4 past it, on ``cuda``; the plain version on ``cpu``),
``SA-TORCH`` (the plain version everywhere, in place of ``SA-JAX``),
``BMS`` (heat-bath: K2, K4), ``SA-NATIVE`` where g++ builds it (the host's
C++ annealer), and the structured calls the models make, ``SA-GROUPS`` and
``BMS-GROUPS``; BMS runs ``--sweeps`` warm-up sweeps, as every column runs
``--sweeps`` sweeps.  Each cell is ms a call: the mean of 3 calls after a
warm-up call, by CUDA events after ``synchronize()`` on ``cuda``,
by the host clock on ``cpu``.  The CSV is the script's; its sidecar
``<out>.device.txt`` starts with the device and, on ``cuda``, its name and
power limit from ``nvidia-smi``.  ``--plot`` draws the figure beside the CSV
and needs matplotlib (absent on the card's machine: it refuses there).

    python -m qbmx_torch.cli.anneal_time_bench --device cuda \\
        --sizes 4 8 16 32 64 128 241 242 717 3368 3369 4096 --sweeps 100
"""

from __future__ import annotations

import argparse
import csv
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from qbmx_torch.core.qubo import densify_groups, random_qubo_batch
from qbmx_torch.models.base import resolve_device
from qbmx_torch.samplers.api import get_sampler
from qbmx_torch.utils import plots

GROUP_COLS = {"SA-GROUPS": "SA", "BMS-GROUPS": "BMS"}
REPS = 3  # timed calls a cell, after a warm-up call


def native_built() -> bool:
    """Whether the host's C++ annealer builds (g++) and loads here."""
    from qbmx_torch.samplers import native

    try:
        native.load_library()
    except (OSError, RuntimeError, subprocess.CalledProcessError, FileNotFoundError):
        return False
    return True


def device_line(dev: torch.device) -> str:
    if dev.type != "cuda":
        return "device: cpu (host clock)"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    return f"device: {torch.cuda.get_device_name(dev)} | nvidia-smi: {smi[0]} (CUDA events)"


def time_call(fn, dev: torch.device, reps: int) -> float:
    """Mean ms of ``fn()`` over ``reps`` calls after a warm-up call."""
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def bench(sizes, reads: int = 100, sweeps: int = 1000, batch: int = 60, seed: int = 0,
          reps: int = REPS, device: str = "cuda", solvers=None) -> tuple[list[dict], list[str]]:
    """The rows ``{"n": n, column: ms, ...}`` and the columns, in order."""
    dev = resolve_device(device)
    solvers = solvers or ["SA", "SA-TORCH", "BMS"] + (["SA-NATIVE"] if native_built() else [])
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    rows = []
    for n in sizes:
        Qs = random_qubo_batch(rng, 1, n).to(dev)
        h = torch.as_tensor(rng.normal(size=(1, batch, n)).astype(np.float32), device=dev)
        Q = densify_groups(Qs, h)
        row = {"n": n}
        for solver in solvers:
            s = get_sampler(solver, num_sweeps=sweeps, num_warmup=sweeps)
            row[solver] = round(time_call(lambda: s.sample_batch(gen, Q, reads), dev, reps), 2)
        for col, solver in GROUP_COLS.items():
            s = get_sampler(solver, num_sweeps=sweeps, num_warmup=sweeps)
            row[col] = round(time_call(lambda: s.sample_groups(gen, Qs, h, reads), dev, reps), 2)
        rows.append(row)
        print(row, flush=True)
    return rows, [*solvers, *GROUP_COLS]


def write_csv(rows, columns, out: str, header: str) -> Path:
    path = Path(out)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["n", *columns])
        w.writeheader()
        w.writerows(rows)
    path.with_suffix(".device.txt").write_text(header + "\n")
    return path


def plot(rows, columns, out: str, batch: int, reads: int, sweeps: int) -> str:
    plt = plots.pyplot()  # raises with a clear message where matplotlib is absent
    fig, ax = plt.subplots()
    for col in columns:
        ax.plot([r["n"] for r in rows], [r[col] for r in rows], marker="o", label=col)
    ax.set_xlabel("QBM size (variables)")
    ax.set_ylabel(f"ms per batch ({batch}×{reads} reads, {sweeps} sweeps)")
    ax.legend()
    ax.set_yscale("log")
    png = str(Path(out).with_suffix(".png"))
    fig.savefig(png, bbox_inches="tight")
    plt.close(fig)
    return png


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reads", type=int, default=100)
    ap.add_argument("--sweeps", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=60)
    ap.add_argument("--sizes", type=int, nargs="*", default=[4, 8, 16, 32, 64, 128])
    ap.add_argument("--out", type=str, default="out/anneal_time_per_qbm_size.csv")
    ap.add_argument("--plot", action="store_true")
    ap.add_argument("--seed", type=int, default=0, help="draws the problems")
    ap.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--solvers", type=str, nargs="*", default=None,
                    help="the dense columns (default: SA SA-TORCH BMS, and SA-NATIVE where "
                         "built); the structured columns always run")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.plot:
        plots.pyplot()  # refuse before the timings, not after
    dev = resolve_device(args.device)
    rows, columns = bench(args.sizes, args.reads, args.sweeps, args.batch, args.seed,
                          device=args.device, solvers=args.solvers)
    header = (f"{device_line(dev)}; reads {args.reads}, sweeps {args.sweeps}, batch "
              f"{args.batch}, seed {args.seed}, {REPS} timed calls a cell after a warm-up")
    path = write_csv(rows, columns, args.out, header)
    print(header)
    print(f"wrote {path} and {path.with_suffix('.device.txt')}")
    if args.plot:
        print(f"wrote {plot(rows, columns, args.out, args.batch, args.reads, args.sweeps)}")
    return rows


if __name__ == "__main__":
    main()
