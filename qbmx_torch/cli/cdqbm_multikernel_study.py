"""Multi-kernel CDQBM exact-gradient study (counterpart of
``scripts/cdqbm_multikernel_study.py``).

Question: does the obvious capacity lever, several conv channels
(``n_kernels``), let the CDQBM family reach the flat Disc_QBM on MedMNIST?
The harness and the flat rows of ``cdqbm_breast_exact_study`` on
breastmnist and then pneumoniamnist: a stratified 160-image train
subsample, exact NLL gradients, 300 Adam steps at lr 0.05, signed inputs
and absmax pooling.  Channels are compared both ways: widening C at fixed
per-channel geometry (7, 11, 15 QUBO variables), and at a matched 11-variable
budget (C=2 seq[2] against C=1 seq[6]); a C=3 row without a sequential
layer, and the flat Disc_QBM at h = 5 and 10 as the bar.

Each model starts from the parameters ``qbmx`` draws for its seed.  The
data come from ``medmnist/{breastmnist,pneumoniamnist}.npz`` under
``$QBMX_DATA_DIR``, ``./data`` or ``./src/data``; the study's results on
the real images wait until those files are at hand.

Usage::

    python -m qbmx_torch.cli.cdqbm_multikernel_study [--device cuda|cpu]

Writes ``out/parity_torch/cdqbm_multikernel_study.md`` under the working
directory (never ``qbmx``'s ``out/parity/``).  ``--device`` defaults to
``cuda``; a missing GPU raises, the run never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np

from qbmx_torch.cli.cdqbm_breast_exact_study import (LR, STEPS, TRAIN_SUBSAMPLE, cdqbm_p1,
                                                     load_medmnist, run_dqbm, train_exact)
from qbmx_torch.cli.exact_harness import eval_metrics
from qbmx_torch.models.base import resolve_device
from qbmx_torch.models.cdqbm import CDQBM
from qbmx_torch.samplers.api import GibbsSampler

OUT = Path("out/parity_torch/cdqbm_multikernel_study.md")
DATASETS = ("breastmnist", "pneumoniamnist")


def run_cdqbm(name, data, *, device="cuda", **model_kw):
    Xtr, Ytr, Xte, Yte = data
    m = CDQBM(
        image_shape=(28, 28), num_label_nodes=1, seed=7, sample_count=8,
        sampler=GibbsSampler(num_warmup=2), hidden_bias_type="shared",
        pool_select="absmax", device=device, **model_kw,
    )
    if m.geo.n_total > 15:
        raise ValueError(f"{name}: {m.geo.n_total} vars too large")
    # signed inputs: the fullstack family config every prior study used
    Xtr, Xte = Xtr * 2.0 - 1.0, Xte * 2.0 - 1.0
    p1 = lambda p, x: cdqbm_p1(m, p, x)
    params, nll = train_exact(p1, m.params, Xtr, Ytr)
    acc_tr, _ = eval_metrics(p1, params, Xtr, Ytr)
    acc_te, auc_te = eval_metrics(p1, params, Xte, Yte)
    return dict(name=name, vars=m.geo.n_total, nll=nll,
                acc_train=acc_tr, acc_test=acc_te, auc_test=auc_te)


DET = dict(kernel_size=7, stride=7, pooling_size=2,
           pooling_type="deterministic")


def variants(data, device="cuda"):
    cd = lambda name, **kw: lambda: run_cdqbm(name, data, device=device, **kw)
    return [
        cd("C=1 k7s7 pool2 seq[2] (parity family)", n_kernels=1,
           sequential_layer_sizes=[2], **DET),
        cd("C=2 k7s7 pool2 seq[2]", n_kernels=2, sequential_layer_sizes=[2], **DET),
        cd("C=3 k7s7 pool2 seq[2]", n_kernels=3, sequential_layer_sizes=[2], **DET),
        # matched 11-var budget: second channel vs wider sequential layer
        cd("C=1 k7s7 pool2 seq[6] (11-var control)", n_kernels=1,
           sequential_layer_sizes=[6], **DET),
        # channels without the seq bottleneck (pool fed straight to output)
        cd("C=3 k7s7 pool2 seq[] (no seq layer)", n_kernels=3,
           sequential_layer_sizes=[], **DET),
        lambda: run_dqbm("flat Disc_QBM h=5", data, n_hidden=5, device=device),
        lambda: run_dqbm("flat Disc_QBM h=10, lr 0.01", data, n_hidden=10, lr=0.01,
                         device=device),
    ]


def build_parser():
    ap = argparse.ArgumentParser(description="Multi-kernel CDQBM exact-gradient study")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device; 'cuda' needs a GPU (no CPU fallback)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    out_lines = [
        "# Multi-kernel CDQBM exact-gradient study",
        "",
        f"Stratified {TRAIN_SUBSAMPLE}-image train subsample, full test",
        f"split; exact NLL gradients by Boltzmann enumeration; {STEPS} Adam",
        f"steps, lr {LR}; signed inputs + absmax pooling (the fullstack",
        "family config of PARITY.md §4).  n_kernels=1 rows are the prior",
        f"single-kernel family; the flat Disc_QBM rows are the bar. Device: {device}.",
    ]
    rows = {}
    for ds in DATASETS:
        rng = np.random.default_rng(0)
        data = load_medmnist(ds, rng)
        maj = float(max((data[3] == 1).mean(), (data[3] == 0).mean()))
        out_lines += [
            "",
            f"## {ds} (majority-class test baseline {maj:.4f} acc / 0.50 AUC)",
            "",
            "| variant | QUBO vars | train NLL | train acc | test acc | test AUC |",
            "|---|---|---|---|---|---|",
        ]
        rows[ds] = []
        for i, v in enumerate(variants(data, device)):
            t0 = time.time()
            r = v()
            r["seconds"] = time.time() - t0
            rows[ds].append(r)
            line = (f"| {r['name']} | {r['vars']} | {r['nll']:.4f} | "
                    f"{r['acc_train']:.3f} | {r['acc_test']:.3f} | "
                    f"{r['auc_test']:.3f} |")
            out_lines.append(line)
            print(f"[{ds} {i + 1}] {line} ({r['seconds']:.0f}s)", flush=True)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text("\n".join(out_lines) + "\n")
    print(f"wrote {OUT}")
    return rows


if __name__ == "__main__":
    main()
