"""Reload a seed sweep's best-epoch weight pickles and reproduce the
recorded metrics (the counterpart of ``scripts/reload_best_model.py``).

A ``--seed_sweep ... --save <folder>/`` run writes each seed's best-epoch
weights under ``<folder>/best_model/`` (``*_best.pkl``: the port's sweeps
and ``qbmx``'s write the same pickles, and either package loads both).
Each pickle is loaded into a fresh ``DiscQBM`` (``load_path``) and predicts
the test split; the reloaded accuracy and AUC land at the sweep's recorded
best-epoch metrics up to the sampling noise of the predicted marginals.
The flags are the script's, plus ``--device`` (default ``cuda``, as the
CLIs: a missing GPU raises), ``--seed``, the ``-s`` the sweep ran with,
which draws its data split (default: ``qbm_main``'s default seed; the
script fixes 0, which reloads a ``qbm_main`` sweep onto another split),
and ``--anneal``, the predicting sweeps (the script's 1000).

    python -m qbmx_torch.cli.qbm_main --data_set synthetic -hn 2 --seed_sweep 3 4 5 \\
        --save out/sweep/
    python -m qbmx_torch.cli.reload_best_model out/sweep/best_model --data_set synthetic \\
        --hnodes 2
"""

from __future__ import annotations

import argparse
import re
from pathlib import Path

import numpy as np

from qbmx_torch.cli import qbm_main
from qbmx_torch.cli._common import load_dataset
from qbmx_torch.data import loaders
from qbmx_torch.models.base import resolve_device
from qbmx_torch.models.dqbm import DiscQBM
from qbmx_torch.utils.metrics import get_metrics


#: ``qbm_main -s``'s default: the seed that draws a sweep's data split
QBM_MAIN_SEED = qbm_main.build_parser().get_default("seed")


def seed_of(path: Path) -> str:
    """The seed in a best-epoch pickle's name: the sweeps write
    ``<name>_se<seed>_e<epoch>_best``, whatever the run's name."""
    m = re.search(r"_se(\d+)_e\d+_best$", path.stem)
    return m.group(1) if m else path.stem


def reload_best_models(folder, data_set: str = "breastmnist", hnodes: int = 5,
                       restricted: bool = False, sample_count: int = 4000,
                       seed: int = QBM_MAIN_SEED, device: str = "cuda",
                       anneal: int = 1000) -> list[tuple[str, float, float]]:
    """``(seed, test acc, test AUC)`` of each ``*_best.pkl`` under ``folder``
    reloaded into a ``DiscQBM`` (SA, ``anneal`` sweeps, ``sample_count``
    reads) on ``device``, on the test split of ``data_set`` drawn with
    ``seed``."""
    pickles = sorted(Path(folder).glob("*_best.pkl"))
    if not pickles:
        raise SystemExit(f"no *_best.pkl under {folder}")
    dev = resolve_device(device)
    (train_X, _), _, (test_X, test_y) = load_dataset(data_set, seed=seed)
    train_X, test_X, _ = loaders.preprocess_images(train_X, test_X, None)
    out = []
    for p in pickles:
        try:
            model = DiscQBM(dim_input=train_X.shape[1], n_hidden_nodes=hnodes, seed=0,
                            solver="SA", restricted=restricted, sample_count=sample_count,
                            anneal_steps=anneal, load_path=str(p), device=dev)
        except ValueError as e:
            raise SystemExit(f"{p.name}: {e}\n(--hnodes/--restricted must match the sweep "
                             "config the best_model/ pickles were written with)") from e
        preds, _ = model.predict_batch(test_X)
        acc, _, _, _, auc = get_metrics(test_y, preds, ["0", "1"])
        out.append((seed_of(p), acc, auc))
        print(f"seed {seed_of(p)}: reloaded winner ({p.name}) test acc {acc:.4f} auc {auc:.4f}",
              flush=True)
    accs, aucs = [r[1] for r in out], [r[2] for r in out]
    print(f"MEAN reloaded acc {np.mean(accs):.4f}±{np.std(accs):.4f} "
          f"auc {np.mean(aucs):.4f}±{np.std(aucs):.4f} over {len(out)} winners")
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("folder", help="best_model/ directory of *_best.pkl files")
    ap.add_argument("--data_set", type=str, default="breastmnist",
                    help="breastmnist, pneumoniamnist, mnist, fashionmnist, cifar-10, synthetic")
    ap.add_argument("--hnodes", type=int, default=5,
                    help="must match the sweep config the pickles came from")
    ap.add_argument("--restricted", action="store_true",
                    help="pickles from a restricted (5-tuple) sweep")
    ap.add_argument("--sample_count", type=int, default=4000,
                    help="predict reads (marginal noise ~ 1/sqrt(reads))")
    ap.add_argument("--seed", type=int, default=QBM_MAIN_SEED,
                    help="the -s the sweep ran with: it draws the data split "
                         "(default: qbm_main's)")
    ap.add_argument("--anneal", type=int, default=1000, help="predict sweeps")
    ap.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    return reload_best_models(args.folder, args.data_set, args.hnodes, args.restricted,
                              args.sample_count, args.seed, args.device, args.anneal)


if __name__ == "__main__":
    main()
