"""Exact-enumeration capacity study of the CDQBM on a bars task
(counterpart of ``scripts/cdqbm_exact_study.py``).

Question: does the reference architecture's deterministic argmin pooling
cap discriminative power?  Tiny CDQBMs (≤ 14 QUBO variables) on a cleanly
separable bars task (6×6 horizontal against vertical bars, 5% pixel
noise, 80 train / 80 test images) are trained with EXACT gradients:
p(y|x) by full Boltzmann enumeration of the unclamped QUBO
(``cli/exact_harness.py``), the NLL minimized by 400 Adam steps.  The 14
variants: argmin pooling on raw and signed inputs, ``center_fmap``,
absmax pooling (raw and signed), probabilistic pooling (at the
reference's penalty, a penalty sweep, learned per-window penalties),
and no pooling.  Also reported: the input-sensitivity of the pooled conv
biases (their std across the dataset, averaged over units).

Each model starts from the parameters ``qbmx`` draws for its seed, so the
table can be held row by row against ``qbmx``'s recorded
``out/parity/cdqbm_exact_study.md``.

Usage::

    python -m qbmx_torch.cli.cdqbm_exact_study [--device cuda|cpu]

Writes ``out/parity_torch/cdqbm_exact_study.md`` under the working
directory (never ``qbmx``'s ``out/parity/``).  ``--device`` defaults to
``cuda``; a missing GPU raises, the run never falls back to the CPU.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from qbmx_torch.cli import exact_harness as xh
from qbmx_torch.models.base import resolve_device
from qbmx_torch.models.cdqbm import CDQBM
from qbmx_torch.samplers.api import GibbsSampler

OUT = Path("out/parity_torch/cdqbm_exact_study.md")


def make_bars(rng, n_per_class=40, side=6, noise=0.05):
    """Horizontal-bar (y=0) vs vertical-bar (y=1) images with pixel noise."""
    X, Y = [], []
    for y in (0, 1):
        for _ in range(n_per_class):
            img = np.zeros((side, side), dtype=np.float32)
            pos = rng.integers(0, side)
            if y == 0:
                img[pos, :] = 1.0
            else:
                img[:, pos] = 1.0
            flip = rng.uniform(size=img.shape) < noise
            img = np.where(flip, 1.0 - img, img)
            X.append(img)
            Y.append(y)
    idx = rng.permutation(len(X))
    return np.stack(X)[idx], np.asarray(Y, np.float32)[idx]


def exact_p1(model, params, x_imgs, beta=1.0):
    """(N,) exact Boltzmann p(y=1|x) of the unclamped QUBOs of images
    ``x_imgs`` (N, H, W) (one binary label node)."""
    return xh.cdqbm_p1(model, params, x_imgs, beta)


def train_exact(model, X, Y, steps=400, lr=0.05, beta=1.0, seed=0):
    """Adam on the exact NLL from ``model.params``: ``(params, final NLL)``."""
    return xh.train_exact(lambda p, x: exact_p1(model, p, x, beta), model.params, X, Y,
                          steps=steps, lr=lr)


def evaluate(model, params, X, Y, beta=1.0):
    """Accuracy of p(y=1|x) > 0.5."""
    return xh.accuracy(xh.predict_p1(lambda p, x: exact_p1(model, p, x, beta), params, X), Y)


def pooled_bias_sensitivity(model, params, X):
    """Std across the dataset (population std, as numpy's) of each
    conv-diagonal bias, averaged: the amount of input information the QUBO
    actually carries in its conv block."""
    with torch.no_grad():
        x = torch.as_tensor(np.asarray(X, dtype=np.float32), device=model.device)
        b = model._conv_linear_terms(params, model._context(params, x))  # (N, conv_active)
    return float(b.std(dim=0, correction=0).mean())


def make_model(image_shape, device="cuda", **model_kw):
    """A study CDQBM (one label node, seed 7) with ``qbmx``'s initial
    parameters."""
    return CDQBM(
        image_shape=image_shape, num_label_nodes=1, seed=7,
        sample_count=8, sampler=GibbsSampler(num_warmup=2), device=device, **model_kw,
    )


def run_variant(name, X, Y, Xt, Yt, *, signed=False, steps=400, device="cuda", **model_kw):
    m = make_model(X.shape[1:], device, **model_kw)
    n_total = m.geo.n_total
    if n_total > 16:
        raise ValueError(f"{name}: {n_total} vars too large for enumeration")
    Xs = X * 2.0 - 1.0 if signed else X
    Xts = Xt * 2.0 - 1.0 if signed else Xt
    params, nll = train_exact(m, Xs, Y, steps=steps)
    acc_tr = evaluate(m, params, Xs, Y)
    acc_te = evaluate(m, params, Xts, Yt)
    sens = pooled_bias_sensitivity(m, params, Xs)
    return dict(name=name, vars=n_total, nll=nll, acc_train=acc_tr,
                acc_test=acc_te, sensitivity=sens)


def variants():
    """The 14 rows: (name, run_variant keywords)."""
    det = dict(kernel_size=3, pooling_size=2, pooling_type="deterministic",
               sequential_layer_sizes=[2], hidden_bias_type="shared")
    prob = dict(kernel_size=4, pooling_size=2, pooling_type="probabilistic",
                sequential_layer_sizes=[2], hidden_bias_type="shared")
    rows = [
        ("parity (argmin pool, raw input)", det),
        ("signed input (x→2x−1)", dict(signed=True, **det)),
        ("center_fmap=True", dict(center_fmap=True, **det)),
        ("pool_select=absmax", dict(pool_select="absmax", **det)),
        ("absmax + signed", dict(signed=True, pool_select="absmax", **det)),
        ("probabilistic pooling", prob),
        ("no pooling", dict(kernel_size=4, pooling_size=0, pooling_type="deterministic",
                            sequential_layer_sizes=[2], hidden_bias_type="shared")),
    ]
    # penalty-strength sweep: the reference hardcodes 0.8225
    rows += [(f"prob pooling, penalty={pen}", dict(prob_penalty=pen, **prob))
             for pen in (0.25, 2.0, 5.0, 10.0)]
    # per-window LEARNED penalties: pen becomes a trained parameter vector
    rows += [(f"prob pooling, LEARNED per-window pen (init={pen0})",
              dict(prob_penalty=pen0, learn_penalty=True, **prob)) for pen0 in (0.8225, 5.0)]
    rows.append(("prob pooling, LEARNED pen + signed input",
                 dict(signed=True, prob_penalty=0.8225, learn_penalty=True, **prob)))
    return rows


def build_parser():
    ap = argparse.ArgumentParser(description="CDQBM exact-enumeration capacity study")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device; 'cuda' needs a GPU (no CPU fallback)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    rng = np.random.default_rng(0)
    X, Y = make_bars(rng, n_per_class=40)
    Xt, Yt = make_bars(rng, n_per_class=40)
    rows = [run_variant(name, X, Y, Xt, Yt, device=device, **kw) for name, kw in variants()]

    lines = [
        "# CDQBM exact-enumeration capacity study",
        "",
        "Bars task (6×6, horizontal vs vertical, 5% pixel noise, 80 train / 80 test);",
        "exact NLL gradients (full Boltzmann enumeration of the unclamped QUBO),",
        "400 Adam steps. `sensitivity` = std across the dataset of the conv-block",
        "QUBO biases (how much input information the QUBO carries), mean over units.",
        f"Device: {device}.",
        "",
        "| variant | QUBO vars | train NLL | train acc | test acc | bias sensitivity |",
        "|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['name']} | {r['vars']} | {r['nll']:.4f} | {r['acc_train']:.3f} "
            f"| {r['acc_test']:.3f} | {r['sensitivity']:.4f} |"
        )
        print(lines[-1])
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text("\n".join(lines) + "\n")
    print(f"wrote {OUT}")
    return rows


if __name__ == "__main__":
    main()
