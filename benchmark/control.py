"""The readings the check's limits are set from, at a cell's own size:

    python3 benchmark/control.py --workload flat_h5.sweep10_sa --seeds 11 12 13 \\
        --modes sound control unchanged half_batch altered_samples altered_answers

For each seed and mode one process-wide set-up of the cell and its
warm-up (the recorded first steps and validation, as every run makes
them, with no window), then the check's numbers.  ``sound`` runs the
program as it is; ``control`` puts the reference in the program's place,
computed in TF32 (one precision below the configuration's float32); the
other modes plant a fault underneath the timed path
(``benchmark/cell.py``).  Prints a JSON line a reading, then, per mode,
the largest and the smallest reading of each number.  The benchmark's own
runs do not run this; it needs the card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if not __package__:
    sys.path[0] = str(ROOT)

MODES = ("sound", "control", "unchanged", "half_batch", "altered_samples", "altered_answers",
         "short_anneal", "mask_ignored")


def reading(workload: str, seed: int, mode: str, device, shape=None) -> dict:
    """The check's numbers of one seed in one mode."""
    from benchmark import check, data as bdata
    from benchmark.run import build, free, judge, warm_up

    b = build(workload, seed, device, None if mode in ("sound", "control") else mode, shape)
    if mode == "control":
        free(b)
        warm = bdata.splits(b.data, b.t)["warm"]
        j = check.Judge(b.cfg, b.mix, b.data, b.weights, seed, device)
        return j.numbers(j.control_recording(warm[2]), warm[2])
    warm_up(b)
    return judge(b, free(b))


def detail(workload: str, seed: int, device) -> dict:
    """A sound reading's per-leaf norms: the first gradient and the change."""
    from benchmark import check, data as bdata
    from benchmark.run import build, free, warm_up

    b = build(workload, seed, device)
    warm_up(b)
    j = check.Judge(b.cfg, b.mix, b.data, b.weights, seed, device)
    num = j.numbers(free(b), bdata.splits(b.data, b.t)["warm"][2])
    return {**num, **j.detail}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--modes", nargs="+", choices=MODES, default=list(MODES))
    p.add_argument("--detail", action="store_true",
                   help="print a sound reading's per-leaf norms for each seed instead")
    a = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    if a.detail:
        for seed in a.seeds:
            print(json.dumps({"seed": seed, **detail(a.workload, seed, device)}), flush=True)
        return 0
    table = {}
    for mode in a.modes:
        for seed in a.seeds:
            t = time.perf_counter()
            num = reading(a.workload, seed, mode, device)
            print(json.dumps({"workload": a.workload, "mode": mode, "seed": seed,
                              "seconds": time.perf_counter() - t,
                              **{k: (v if v == v and abs(v) != float("inf") else str(v))
                                 for k, v in num.items()}}), flush=True)
            for k, v in num.items():
                lo, hi = table.setdefault((mode, k), (v, v))
                table[mode, k] = (min(lo, v), max(hi, v))
    for (mode, k), (lo, hi) in table.items():
        print(f"{a.workload} {mode} {k} smallest {lo!r} largest {hi!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
