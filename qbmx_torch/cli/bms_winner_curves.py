"""Full per-seed metric curves for the search winner, BMS h8 lr0.55 bs36
(counterpart of ``scripts/bms_winner_curves.py``).

Dumps every (seed, epoch) test acc/AUC pair of one ``SeedParallelDQBM``
sweep on breastmnist, so the Pareto front of the selection is visible (the
search's JSONL keeps only best-by-acc points and the joint-criterion
flags), and prints the acc/AUC fronts, hard-scored and probability-scored.
Output: ``out/parity_torch/bms_winner_curves{--out_tag}.json`` under the
working directory (never ``qbmx``'s ``out/parity/``).  ``--device``
defaults to ``cuda``; a missing GPU raises, the run never falls back to
the CPU.

Usage::

    python -m qbmx_torch.cli.bms_winner_curves [--h 8 --lr 0.55 --bs 36 --e 40 \\
        --solver BMS --seeds 30 --predict_reads N --out_tag TAG] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import time

from qbmx_torch.cli.bms_hyper_search import (EXTRA_SEEDS, OUT, REF_ACC, REF_AUC,
                                             breast_data)
from qbmx_torch.cli.rbm_main import DEFAULT_SEEDS
from qbmx_torch.models.base import resolve_device
from qbmx_torch.train.sweep import SeedParallelDQBM


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--h", type=int, default=8)
    ap.add_argument("--lr", type=float, default=0.55)
    ap.add_argument("--bs", type=int, default=36)
    ap.add_argument("--e", type=int, default=40)
    ap.add_argument("--solver", type=str, default="BMS")
    ap.add_argument("--seeds", type=int, default=30)
    ap.add_argument("--out_tag", type=str, default="",
                    help="suffix for the output json (multi-config scans)")
    ap.add_argument("--predict_reads", type=int, default=None,
                    help="eval-time reads (default: same as training's 1000);"
                         " marginal noise ~1/sqrt(reads) bounds prob-AUC"
                         " ranking resolution")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device; 'cuda' needs a GPU (no CPU fallback)")
    return ap


def print_fronts(cfg, dt, curves):
    """The top runs by accuracy, the acc/AUC Pareto front, and the same
    selection scored on probabilities."""
    pts = [(a, u, s, e + 1) for s, c in curves.items()
           for e, (a, u) in enumerate(zip(c["acc"], c["auc"]))]
    pts.sort(key=lambda p: (-p[0], -p[1]))
    print(f"config {cfg}  [{dt:.0f}s]")
    print("top by acc:")
    for a, u, s, e in pts[:8]:
        print(f"  acc {a:.4f} auc {u:.4f}  seed {s} e{e}")
    pareto = []
    best_u = -1.0
    for a, u, s, e in pts:
        if u > best_u:
            pareto.append((a, u, s, e))
            best_u = u
    print("acc/AUC Pareto front (desc acc):")
    for a, u, s, e in pareto:
        tag = " <= JOINT BEAT" if a >= REF_ACC and u >= REF_AUC else ""
        print(f"  acc {a:.4f} auc {u:.4f}  seed {s} e{e}{tag}")
    print("max auc anywhere:", max(pts, key=lambda p: p[1]))

    # probability-scored AUC (standard ROC protocol; the reference scores
    # hard predictions): same selection, prob scores
    ppts = [(a, pu, s, e + 1) for s, c in curves.items()
            for e, (a, pu) in enumerate(zip(c["acc"], c["prob_auc"]))]
    ppts.sort(key=lambda p: (-p[0], -p[1]))
    print("top by acc (prob-scored AUC):")
    for a, pu, s, e in ppts[:8]:
        tag = " <= JOINT BEAT (prob protocol)" if a >= REF_ACC and pu >= REF_AUC else ""
        print(f"  acc {a:.4f} prob_auc {pu:.4f}  seed {s} e{e}{tag}")
    print("max prob_auc anywhere:", max(ppts, key=lambda p: p[1]))
    njoint = sum(1 for a, pu, _, _ in ppts if a >= REF_ACC and pu >= REF_AUC)
    print(f"joint (acc>={REF_ACC}, prob_auc>={REF_AUC}) points: {njoint}")
    return pareto


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    (train_X, train_y), (test_X, test_y) = breast_data()
    # seed pool extends deterministically past the search's 30 (same
    # first-30 prefix, so larger pools strictly extend the selection)
    pool = list(DEFAULT_SEEDS) + EXTRA_SEEDS
    pool += [1009 + 29 * i for i in range(max(args.seeds - len(pool), 0))]
    seeds = pool[: args.seeds]

    t0 = time.time()
    sweep = SeedParallelDQBM(
        seeds, dim_input=train_X.shape[1], n_hidden_nodes=args.h,
        restricted=False, sample_count=1000, anneal_steps=1000,
        solver=args.solver, predict_sample_count=args.predict_reads, device=device)
    hists = sweep.train(train_X, train_y, test_X, test_y, epochs=args.e,
                        batch_size=args.bs, learning_rate=args.lr,
                        verbose=False)
    dt = time.time() - t0

    curves = {str(s): {"acc": h.acc_per_epoch, "auc": h.auc_per_epoch,
                       "prob_auc": h.prob_auc_per_epoch}
              for s, h in zip(seeds, hists)}
    cfg = {"solver": args.solver, "h": args.h, "lr": args.lr,
           "bs": args.bs, "e": args.e, "n_seeds": args.seeds,
           "predict_reads": args.predict_reads or 1000}
    OUT.mkdir(parents=True, exist_ok=True)
    path = OUT / f"bms_winner_curves{args.out_tag}.json"
    with open(path, "w") as f:
        json.dump({"cfg": cfg, "time_s": dt, "curves": curves}, f)
    print_fronts(cfg, dt, curves)
    return path


if __name__ == "__main__":
    main()
