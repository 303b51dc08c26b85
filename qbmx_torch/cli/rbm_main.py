"""Discriminative RBM CLI on PyTorch — the flags, defaults, seed list,
guards, pickle names and printed lines of ``qbmx.cli.rbm_main`` plus
``--device`` (default ``cuda``; a missing GPU raises, the run never falls
back to the CPU).

Per seed: load the data, train a ``ClassificationRBM``, write the per-epoch
accuracy and AUC pickles.  ``--seed_parallel`` trains every seed as one
batched sweep (``train/sweep.SeedParallelRBM``) and writes each seed's
best-epoch weights under ``best_model/``.  ``--checkpoint_every N`` writes
each seed's full state every N epochs to ``<out>/state_se<seed>.npz``,
and ``--resume <npz>`` continues one seed from such a state exactly
(``utils/checkpoint.py``).

    python -m qbmx_torch.cli.rbm_main --device cuda --data_set synthetic --epochs 1
"""

from __future__ import annotations

import argparse
import pickle
from pathlib import Path

import numpy as np

from qbmx_torch.cli._common import load_dataset
from qbmx_torch.data import loaders
from qbmx_torch.models.base import resolve_device
from qbmx_torch.models.rbm import ClassificationRBM
from qbmx_torch.train.sweep import SeedParallelRBM
from qbmx_torch.utils.checkpoint import load_checkpoint

# Reference's fixed seed list (``rbm_main.py:32-33``)
DEFAULT_SEEDS = [
    1967690937, 2286980494, 3620295971, 1662044193, 1825595160,
    3054779705, 900327972, 1620954898, 3699850877, 3492574433,
]


def build_parser():
    p = argparse.ArgumentParser(description="Discriminative RBM seed sweep (PyTorch / CUDA)")
    p.add_argument("--lr", type=float, default=0.08714599435919934,
                   help="initial learning rate")
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=7)
    p.add_argument("--visible-units", type=int, default=784)
    p.add_argument("--hidden-units", type=int, default=9)
    p.add_argument("--cd-k", type=int, default=1,
                   help="K in contrastive divergence (generative/hybrid modes)")
    p.add_argument("--type", type=str, default="discriminative",
                   help="'discriminative', 'generative', or 'hybrid'")
    p.add_argument("--sparsity-coeffectient", type=float, default=0.0)
    p.add_argument("--generative-factor", type=float, default=0.01)
    p.add_argument("--data_set", type=str, default="breastmnist")
    p.add_argument("--seeds", type=int, nargs="*", default=None,
                   help="Seed list (default: the reference's 10 seeds)")
    p.add_argument("--out", type=str, default="out/rbm")
    p.add_argument("--seed_parallel", action="store_true",
                   help="Train ALL seeds as one batched sweep "
                        "(qbmx_torch.train.sweep.SeedParallelRBM). Data is "
                        "loaded once (per-seed loads only differ when "
                        "--data_set subsampling/balancing is seeded).")
    p.add_argument("--checkpoint_every", type=int, default=0,
                   help="every N epochs write a full-state npz per seed "
                        "(params + random stream + acc/auc lists); resume with "
                        "--resume for a bit-identical continuation "
                        "(sequential path only)")
    p.add_argument("--resume", type=str, default="",
                   help="full-state npz to resume the (single listed) seed "
                        "from; requires exactly one --seeds value")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' needs a GPU (no CPU fallback)")
    return p


def main(args=None):
    args = args or build_parser().parse_args()
    seeds = args.seeds if args.seeds else DEFAULT_SEEDS
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    if args.seed_parallel:
        if args.resume or args.checkpoint_every:
            raise ValueError("--resume/--checkpoint_every need the "
                             "sequential path (omit --seed_parallel)")
        return _main_seed_parallel(args, seeds, out)

    if args.resume and len(seeds) != 1:
        raise ValueError("--resume restores ONE model: pass exactly one "
                         "--seeds value")
    dev = resolve_device(args.device)

    results = []
    for seed in seeds:
        np.random.seed(seed)
        print("Loading data...")
        (train_X, train_y), (val_X, val_y), (test_X, test_y) = load_dataset(
            args.data_set, seed=seed
        )
        print("Data loaded")
        print("Train shape:", train_X.shape)
        train_X, val_X, test_X = loaders.preprocess_images(train_X, val_X, test_X)

        rbm = ClassificationRBM(
            num_visible=train_X.shape[1], num_hidden=args.hidden_units,
            k=args.cd_k, num_classes=2, learning_rate=args.lr, seed=seed,
            method=args.type, sparse_constant=args.sparsity_coeffectient,
            generative_factor=args.generative_factor, device=dev,
        )
        # full-state resume: parameters, random stream, acc/auc/nll lists
        start_epoch = 0
        if args.resume:
            prev_history, start_epoch = load_checkpoint(args.resume, rbm)
            if prev_history is not None:
                rbm.acc_per_epoch_list = list(prev_history.acc_per_epoch)
                rbm.auc_per_epoch_list = list(prev_history.auc_per_epoch)
                rbm.nll_per_epoch_list = list(prev_history.nll_per_epoch)
            print(f"Resumed full state from {args.resume} "
                  f"(completed epochs: {start_epoch})")
        rbm.train_rbm(
            train_X, train_y, epochs=args.epochs, batch_size=args.batch_size,
            test_x=test_X, test_y=test_y,
            checkpoint_every=args.checkpoint_every,
            checkpoint_path=(str(out / f"state_se{seed}")
                             if args.checkpoint_every else None),
            start_epoch=start_epoch,
        )
        with open(out / f"acc_per_epoch{seed}.pkl", "wb") as f:
            pickle.dump(rbm.acc_per_epoch_list, f)
        with open(out / f"auc_per_epoch{seed}.pkl", "wb") as f:
            pickle.dump(rbm.auc_per_epoch_list, f)
        best = max(rbm.acc_per_epoch_list) if rbm.acc_per_epoch_list else float("nan")
        results.append(best)
        print(f"seed {seed}: best epoch acc {best:.4f}")

    print(f"mean best-epoch acc over {len(seeds)} seeds: {np.mean(results):.4f}")
    return results


def _main_seed_parallel(args, seeds, out: Path):
    dev = resolve_device(args.device)
    print("Loading data...")
    (train_X, train_y), (val_X, val_y), (test_X, test_y) = load_dataset(
        args.data_set, seed=seeds[0]
    )
    train_X, val_X, test_X = loaders.preprocess_images(train_X, val_X, test_X)
    print("Data loaded. Train shape:", train_X.shape)

    sweep = SeedParallelRBM(
        seeds, num_visible=train_X.shape[1], num_hidden=args.hidden_units,
        num_classes=2, k=args.cd_k, learning_rate=args.lr, method=args.type,
        sparse_constant=args.sparsity_coeffectient,
        generative_factor=args.generative_factor, device=dev,
    )
    acc_lists, auc_lists = sweep.sweep(
        train_X, train_y, test_X, test_y, epochs=args.epochs,
        batch_size=args.batch_size,
    )
    results = []
    for seed, accs, aucs in zip(seeds, acc_lists, auc_lists):
        with open(out / f"acc_per_epoch{seed}.pkl", "wb") as f:
            pickle.dump(accs, f)
        with open(out / f"auc_per_epoch{seed}.pkl", "wb") as f:
            pickle.dump(aucs, f)
        results.append(max(accs))
        print(f"seed {seed}: best epoch acc {max(accs):.4f}")
    paths = sweep.save_best_models(out)
    print(f"best-epoch checkpoints: {len(paths)} pickles under "
          f"{out / 'best_model'}")
    print(f"mean best-epoch acc over {len(seeds)} seeds: {np.mean(results):.4f}")
    return results


if __name__ == "__main__":
    main()
