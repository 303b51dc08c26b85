"""The seed bands of two sweeps side by side, and the parity rule between
them (North-star check 3).

Each folder holds what ``qbm_main --seed_sweep ... --save <folder>/``
writes, in either package: ``<name>acc_per_epoch<seed>.pkl`` and
``<name>auc_per_epoch<seed>.pkl``, one value an epoch.  The first folder is
the reference (``qbmx``'s sweep), the second the candidate (the port's).
Both sweeps must hold the same seeds.  For each epoch the report gives
each sweep's mean, min and max of accuracy and AUC across its seeds; the
rule holds where, at every epoch and for both metrics, the two means lie
within :data:`Z` = 2 standard errors of their difference, sqrt(sd_ref² / S
+ sd_cand² / S) over the S seeds (each sd the sample standard deviation
across seeds).  Exit status 0 when it holds, 1 when it fails.  Nothing of
``qbmx`` is imported: the pickles are plain lists.

Held over k comparisons at once (settings × epochs × metrics), the rule
takes the Bonferroni width :func:`bonferroni_z` (k) in place of :data:`Z`,
so that a sound port fails any of them in at most one run of 20.

    python -m qbmx.cli.qbm_main --data_set synthetic -hn 2 ... --seed_sweep 0 1 2 --save ref/
    python -m qbmx_torch.cli.qbm_main --device cpu --data_set synthetic -hn 2 ... \\
        --seed_sweep 0 1 2 --save port/
    python -m qbmx_torch.cli.seed_bands ref/ port/
"""

from __future__ import annotations

import argparse
import math
import pickle
import re
import statistics
import sys
from pathlib import Path

import numpy as np

METRICS = ("acc", "auc")
Z = 2.0  # the band's half-width in standard errors of the difference of means


def load_bands(folder) -> dict:
    """``{"seeds": [...], "acc": (seeds, epochs), "auc": (seeds, epochs)}``
    from a sweep folder's per-seed pickles (seeds in increasing order)."""
    folder = Path(folder)
    found = {}
    for metric in METRICS:
        for p in folder.glob(f"*{metric}_per_epoch*.pkl"):
            m = re.search(rf"{metric}_per_epoch(\d+)\.pkl$", p.name)
            if m:
                with open(p, "rb") as f:
                    found.setdefault(metric, {})[int(m.group(1))] = [float(v) for v in
                                                                     pickle.load(f)]
    if set(found) != set(METRICS) or set(found["acc"]) != set(found["auc"]):
        raise SystemExit(f"{folder}: need acc_per_epoch<seed>.pkl and auc_per_epoch<seed>.pkl "
                         "for the same seeds")
    seeds = sorted(found["acc"])
    lens = {len(found[m][s]) for m in METRICS for s in seeds}
    if len(lens) != 1:
        raise SystemExit(f"{folder}: the seeds' histories differ in length ({sorted(lens)})")
    return {"seeds": seeds, **{m: np.array([found[m][s] for s in seeds]) for m in METRICS}}


def bonferroni_z(k: int, alpha: float = 0.05) -> float:
    """The two-sided Bonferroni width for ``k`` comparisons held together:
    Φ⁻¹(1 − alpha / (2k)) (3.376 at k = 68, 3.392 at k = 72)."""
    return statistics.NormalDist().inv_cdf(1.0 - alpha / (2 * k))


def compare(ref: dict, cand: dict, z: float = Z) -> tuple[bool, list[dict]]:
    """``(holds, rows)``: one row an epoch with each sweep's band and whether
    the two means lie within ``z`` standard errors of their difference."""
    if ref["seeds"] != cand["seeds"]:
        raise SystemExit(f"the sweeps ran seeds {ref['seeds']} and {cand['seeds']}")
    epochs = ref["acc"].shape[1]
    if cand["acc"].shape[1] != epochs:
        raise SystemExit(f"the sweeps ran {epochs} and {cand['acc'].shape[1]} epochs")
    sd = lambda v: float(v.std(ddof=1)) if len(v) > 1 else 0.0
    rows, holds = [], True
    for e in range(epochs):
        row = {"epoch": e + 1}
        for m in METRICS:
            r, c = ref[m][:, e], cand[m][:, e]
            half = z * math.sqrt((sd(r) ** 2 + sd(c) ** 2) / len(r))
            ok = abs(float(c.mean()) - float(r.mean())) <= half
            holds &= ok
            row[m] = {"ref": (float(r.mean()), float(r.min()), float(r.max()), sd(r)),
                      "cand": (float(c.mean()), float(c.min()), float(c.max()), sd(c)),
                      "half_width": half, "ok": ok}
        rows.append(row)
    return holds, rows


def report(ref_dir, cand_dir, z: float = Z) -> bool:
    ref, cand = load_bands(ref_dir), load_bands(cand_dir)
    holds, rows = compare(ref, cand, z)
    print(f"reference {ref_dir}, candidate {cand_dir}: seeds {ref['seeds']}; rule: the means "
          f"within {z:g} standard errors of their difference")
    for row in rows:
        parts = []
        for m in METRICS:
            (rm, rlo, rhi, rsd), (cm, clo, chi, csd) = row[m]["ref"], row[m]["cand"]
            parts.append(f"{m} ref {rm:.4f} [{rlo:.4f}, {rhi:.4f}] sd {rsd:.4f} | cand {cm:.4f} "
                         f"[{clo:.4f}, {chi:.4f}] sd {csd:.4f} | diff {cm - rm:+.4f} of "
                         f"±{row[m]['half_width']:.4f} {'ok' if row[m]['ok'] else 'OUT'}")
        print(f"epoch {row['epoch']}: " + "; ".join(parts))
    print(f"parity rule {'HOLDS' if holds else 'FAILS'}")
    return holds


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("reference", help="the reference sweep's --save folder (qbmx's)")
    ap.add_argument("candidate", help="the candidate sweep's --save folder (the port's)")
    args = ap.parse_args(argv)
    return 0 if report(args.reference, args.candidate) else 1


if __name__ == "__main__":
    sys.exit(main())
