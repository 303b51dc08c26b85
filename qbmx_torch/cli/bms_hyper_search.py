"""Hyperparameter search for the flat Disc_QBM on breastmnist (counterpart
of ``scripts/bms_hyper_search.py``).

Target: the reference's selected-best BMS run (acc 0.8558 / AUC 0.8265,
config h2 bs20 e20 lr≈0.453), a best SINGLE run chosen over large sweeps.
So every config here trains 10–30 seeds as ONE seed-parallel job
(``train/sweep.SeedParallelDQBM``: one sampler launch a step for all
seeds, K1 for SA, K2 for BMS, K3 for PT on the card), and the per-(seed,
epoch) test metrics are scanned for the best single run.

Stages (``--stage``):
  screen  — 10-seed sweeps over solver × h × lr at the reference's bs/e.
  exploit — 30-seed, 30-epoch re-runs of hand-picked top configs.
``--configs`` (a JSON list) replaces the stage's grid; ``--seeds`` sets the
number of seeds (default 10 screen / 30 exploit).

Every config appends one JSON line to
``out/parity_torch/bms_hyper_search.jsonl`` under the working directory
(never ``qbmx``'s ``out/parity/``), so interrupted runs lose nothing, and
the log prints the running best single run.  The data come from
``medmnist/breastmnist.npz`` under ``$QBMX_DATA_DIR``, ``./data`` or
``./src/data``; the search's results on the real images wait until that
file is at hand.  ``--device`` defaults to ``cuda``; a missing GPU raises,
the run never falls back to the CPU.

Usage::

    python -m qbmx_torch.cli.bms_hyper_search --stage screen [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

from qbmx_torch.cli._common import load_dataset
from qbmx_torch.cli.rbm_main import DEFAULT_SEEDS
from qbmx_torch.data import loaders
from qbmx_torch.models.base import resolve_device
from qbmx_torch.train.sweep import SeedParallelDQBM

OUT = Path("out/parity_torch")
REF_ACC, REF_AUC = 0.8558, 0.8265  # the number to beat

# extra seeds beyond the reference's 10, for selection at larger scale
EXTRA_SEEDS = [7 + 13 * i for i in range(20)]


def run_config(data, cfg, seeds, jsonl_path, device="cuda"):
    (train_X, train_y), (test_X, test_y) = data
    t0 = time.time()
    sweep = SeedParallelDQBM(
        seeds, dim_input=train_X.shape[1], n_hidden_nodes=cfg["h"],
        restricted=False, sample_count=cfg.get("sc", 1000),
        anneal_steps=cfg.get("sweeps", 1000), beta_eff=cfg.get("beta_eff", 1.0),
        solver=cfg["solver"], device=device,
    )
    hists = sweep.train(train_X, train_y, test_X, test_y,
                        epochs=cfg.get("e", 20), batch_size=cfg.get("bs", 20),
                        learning_rate=cfg["lr"], verbose=False)
    dt = time.time() - t0

    # best single run = the (seed, epoch) with max acc; AUC read at the
    # same epoch (the reference's result txt reports one model's metrics)
    per_seed = []
    best = {"acc": -1.0}
    for seed, h in zip(seeds, hists):
        accs, aucs = np.asarray(h.acc_per_epoch), np.asarray(h.auc_per_epoch)
        e_best = int(np.argmax(accs))
        per_seed.append({"seed": seed, "acc": float(accs[e_best]),
                         "auc": float(aucs[e_best]), "epoch": e_best + 1})
        if accs[e_best] > best["acc"]:
            best = {"seed": seed, "epoch": e_best + 1,
                    "acc": float(accs[e_best]), "auc": float(aucs[e_best])}
        # joint criterion: any epoch beating BOTH reference numbers
        joint = (accs >= REF_ACC) & (aucs >= REF_AUC)
        if joint.any():
            e = int(np.argmax(joint))
            per_seed[-1]["beats_ref_at_epoch"] = e + 1
            per_seed[-1]["beats_ref"] = {"acc": float(accs[e]), "auc": float(aucs[e])}

    rec = {
        "cfg": cfg, "n_seeds": len(seeds), "time_s": round(dt, 1),
        "mean_acc": float(np.mean([p["acc"] for p in per_seed])),
        "std_acc": float(np.std([p["acc"] for p in per_seed])),
        "mean_auc": float(np.mean([p["auc"] for p in per_seed])),
        "best_single": best,
        "any_beats_ref": any("beats_ref" in p for p in per_seed),
        "per_seed": per_seed,
    }
    Path(jsonl_path).parent.mkdir(parents=True, exist_ok=True)
    with open(jsonl_path, "a") as f:
        f.write(json.dumps(rec) + "\n")
    print(f"{cfg}  mean {rec['mean_acc']:.4f}±{rec['std_acc']:.4f} "
          f"auc {rec['mean_auc']:.4f}  best single acc {best['acc']:.4f} "
          f"(auc {best['auc']:.4f}, seed {best.get('seed')}, e{best.get('epoch')}) "
          f" beats_ref={rec['any_beats_ref']}  [{dt:.0f}s]")
    return rec


SCREEN = (
    [{"solver": "BMS", "h": h, "lr": lr}
     for h in (2, 3, 5, 8) for lr in (0.2, 0.453, 0.8)]
    + [{"solver": "SA", "h": h, "lr": lr}
       for h in (2, 5, 8) for lr in (0.307, 0.453)]
    + [{"solver": "PT", "h": h, "lr": 0.453, "sweeps": 128}
       for h in (2, 5)]
)

# top configs of the screen by best-single acc plus the beta_eff /
# batch-size axes the screen didn't cover
EXPLOIT = [
    {"solver": "SA", "h": 8, "lr": 0.307, "e": 30},
    {"solver": "BMS", "h": 8, "lr": 0.453, "e": 30},
    {"solver": "BMS", "h": 3, "lr": 0.453, "e": 30},
    {"solver": "SA", "h": 2, "lr": 0.453, "e": 30},
    {"solver": "PT", "h": 5, "lr": 0.453, "sweeps": 128, "e": 30},
    {"solver": "BMS", "h": 3, "lr": 0.453, "e": 30, "beta_eff": 2.0},
    {"solver": "BMS", "h": 8, "lr": 0.453, "e": 30, "bs": 36},
    {"solver": "BMS", "h": 5, "lr": 0.3, "e": 30, "beta_eff": 3.0},
]


def breast_data():
    """breastmnist's train and test splits (split seed 0), flattened."""
    (train_X, train_y), _, (test_X, test_y) = load_dataset("breastmnist", seed=0)
    train_X, test_X, _ = loaders.preprocess_images(train_X, test_X, None)
    return (train_X, train_y), (test_X, test_y)


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--stage", choices=("screen", "exploit"), default="screen")
    ap.add_argument("--configs", type=str, default=None,
                    help="JSON list of configs overriding the stage's grid")
    ap.add_argument("--seeds", type=int, default=None,
                    help="number of seeds (default: 10 screen / 30 exploit)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device; 'cuda' needs a GPU (no CPU fallback)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    data = breast_data()

    if args.configs:
        grid = json.loads(args.configs)
    else:
        grid = SCREEN if args.stage == "screen" else EXPLOIT
    n_seeds = args.seeds or (10 if args.stage == "screen" else 30)
    seeds = (list(DEFAULT_SEEDS) + EXTRA_SEEDS)[:n_seeds]

    jsonl = OUT / "bms_hyper_search.jsonl"
    print(f"stage={args.stage}  {len(grid)} configs × {len(seeds)} seeds  "
          f"target acc≥{REF_ACC} auc≥{REF_AUC}")
    t_all = time.time()
    records = [run_config(data, cfg, seeds, jsonl, device) for cfg in grid]
    best = max(records, key=lambda r: r["best_single"]["acc"])
    print(f"\nSTAGE BEST single run: {best['best_single']} from {best['cfg']}")
    print(f"any config beats ref jointly: {any(r['any_beats_ref'] for r in records)}")
    print(f"TOTAL {time.time() - t_all:.0f}s")
    return records


if __name__ == "__main__":
    main()
