"""Conv-Deep-QBM CLI on PyTorch — the flag set and defaults of
``qbmx.cli.cdqbm_main`` plus ``--device`` (default ``cuda``; a missing GPU
raises, the run never falls back to the CPU).

The samplers run their CUDA kernels on ``--device cuda``: the CLI defaults
(deterministic pooling 4, ``--seq_sizes 4``, 41 variables) on K1/K2, and
probabilistic pooling (``--pooling_type probabilistic``, 717 variables at
28×28) on K4 (SA, BMS) or K5 (PT), whose couplings exceed a block's shared
memory; their plain PyTorch versions on ``--device cpu``.  ``SA-NATIVE``
anneals on the host in C++, and a D-Wave solver name builds a QPU adapter
through the Ocean SDK (``--qpu_copies``, ``--qpu_embedding``,
``--embedding_cache``).
``--seed_sweep`` trains every listed seed as one batched sweep
(``train/sweep.SeedParallelCDQBM``: one sampler launch a step for all
seeds; with ``--reinit_on_collapse`` its flatlined seeds are re-drawn).
``--checkpoint_every N`` writes the full training state every N epochs to
``<save><run>/state.npz``, and ``--resume <npz>`` continues from such a
state exactly (``utils/checkpoint.py``).
"""

from __future__ import annotations

import argparse
import os
import random

import numpy as np

from qbmx_torch.cli._common import (finish_seed_sweep, load_dataset, param_string,
                                    qpu_sampler_kwargs, str2bool)
from qbmx_torch.data import loaders
from qbmx_torch.models.base import resolve_device
from qbmx_torch.models.cdqbm import CDQBM
from qbmx_torch.train.loop import train_model
from qbmx_torch.train.sweep import SeedParallelCDQBM
from qbmx_torch.utils import metrics
from qbmx_torch.utils.checkpoint import load_checkpoint


def auc_from_probs(y_true, probs, num_classes: int) -> float:
    """ROC-AUC of the test predictions as ``qbmx``'s CLI takes it with
    scikit-learn: for two classes from the positive-class probability,
    otherwise the macro mean of one-vs-rest AUCs over the probability
    columns.  Raises ``ValueError`` when ``y_true`` lacks a class."""
    y_true = np.asarray(y_true).ravel()
    if num_classes == 2:
        return metrics.binary_auc(y_true, np.asarray(probs)[:, 1])
    return float(np.mean([metrics.binary_auc(y_true == c, np.asarray(probs)[:, c])
                          for c in range(num_classes)]))


def main(
    seed=44, solver="SA", sample_count=100, anneal=1000, beta_eff=1.0, epochs=20,
    batch_size=3, learning_rate=0.01, restricted=False, data_set="mnist",
    num_classes=2, save="out/", name="run", pooling_size=4,
    pooling_type="deterministic", hidden_bias_type="shared", one_hot=False,
    sequential_layer_sizes=(4,), kernel_size=3, stride=1, n_kernels=1,
    coreset_budget=0,
    samples_per_class=50, pool_select="min", center_fmap=False,
    signed_input=False, prob_penalty=0.8225, grad_clip=0.0, progress=False,
    seed_sweep=None, reinit_on_collapse=0, learn_penalty=False,
    checkpoint_every=0, resume="", qpu_copies=1,
    qpu_embedding="first_party", embedding_cache="", device="cuda",
):
    """Train, predict on the test split; returns (acc, f1, precision,
    recall, auc), or with ``seed_sweep`` the per-seed best-epoch ``(accs,
    aucs)`` of one batched sweep over those seeds."""
    if seed_sweep and (resume or checkpoint_every):
        # qbmx's guard: silently ignoring these would lose checkpoints or
        # retrain from scratch while the user believes the flags took effect
        raise ValueError("--resume/--checkpoint_every need the "
                         "single-model path (omit --seed_sweep)")
    dev = resolve_device(device)
    print("Start")
    random.seed(seed)
    np.random.seed(seed)
    print("Seed is", seed)

    print("Loading data...")
    (train_x, train_y), _, (test_x, test_y) = load_dataset(
        data_set, seed=seed, num_classes=num_classes,
        samples_per_class=samples_per_class if data_set in ("mnist", "fashionmnist") else None,
    )
    print("Data loaded")

    train_x, train_y = loaders.shuffle_images(train_x, train_y, seed)

    if signed_input:
        # flag-gated extension (PARITY.md §4): remap inputs to {-1, +1}
        train_x = np.asarray(train_x, dtype=np.float32) * 2.0 - 1.0
        test_x = np.asarray(test_x, dtype=np.float32) * 2.0 - 1.0

    image_shape = np.asarray(train_x[0]).shape[:2]
    num_label_nodes = 1 if (num_classes == 2 and not one_hot) else int(num_classes)
    class_names = ["0", "1"] if num_label_nodes == 1 else [str(i) for i in range(num_classes)]

    pstr = param_string(
        se=seed, sol=solver, sc=sample_count, b=beta_eff, e=epochs,
        bs=batch_size, l=learning_rate, r=restricted, data=data_set, n_=name,
    )
    print(pstr)

    print(f"Creating QBM on {dev}...")
    qbm = CDQBM(
        image_shape=tuple(image_shape), num_label_nodes=num_label_nodes,
        seed=seed, kernel_size=kernel_size, n_kernels=n_kernels,
        pooling_size=pooling_size,
        pooling_type=pooling_type, stride=stride,
        sequential_layer_sizes=list(sequential_layer_sizes),
        is_restricted=bool(restricted), hidden_bias_type=hidden_bias_type,
        solver=solver, anneal=anneal, sample_count=sample_count,
        beta_eff=beta_eff, num_classes=num_classes,
        pool_select=pool_select, center_fmap=center_fmap,
        prob_penalty=prob_penalty, grad_clip=grad_clip,
        learn_penalty=bool(learn_penalty),
        sampler_kwargs=qpu_sampler_kwargs(qpu_copies, qpu_embedding, embedding_cache),
        device=dev,
    )
    print(f"QBM created (hidden={qbm.geo.n_hidden}, total={qbm.geo.n_total})")

    if reinit_on_collapse and not seed_sweep:
        raise ValueError(
            "--reinit_on_collapse requires --seed_sweep here: the "
            "single-model cdqbm path has no per-epoch validation for the "
            "collapse check (qbm_main wires it for single models)")
    if seed_sweep:
        if coreset_budget:
            raise ValueError("--seed_sweep does not compose with "
                             "--coreset_budget (the coreset depends on one "
                             "model's embedding)")
        return _seed_sweep(qbm, seed_sweep, train_x, train_y, test_x, test_y, epochs,
                           batch_size, learning_rate, save, name, class_names,
                           reinit_on_collapse)

    if coreset_budget:
        from qbmx_torch.data.coreset import downsample_kcenter_with_light_model

        print(f"Selecting {coreset_budget}-example coreset...")
        train_x, train_y = downsample_kcenter_with_light_model(
            qbm, train_x, train_y, coreset_budget, seed)

    # full-state resume, as in qbm_main
    start_epoch, prev_history = 0, None
    if resume:
        prev_history, start_epoch = load_checkpoint(resume, qbm)
        print(f"Resumed full state from {resume} (completed epochs: {start_epoch})")
    if checkpoint_every and not save:
        raise ValueError("--checkpoint_every needs --save")
    ckpt_path = f"{save}{pstr}/state" if save and checkpoint_every else None

    print("Training QBM...")
    history = train_model(
        qbm, train_x, train_y, batch_size=batch_size,
        learning_rate=learning_rate, epochs=epochs,
        save_folder=f"{save}{pstr}" if save else None,
        class_titles=class_names, history=prev_history,
        checkpoint_every=checkpoint_every, checkpoint_path=ckpt_path,
        start_epoch=start_epoch, progress=progress,
    )
    print("QBM trained")

    print("Predict on test data...")
    predictions, probs_all = qbm.predict_batch(test_x)

    acc, f1, precision, recall, _ = metrics.get_metrics(test_y, predictions, class_names)
    auc = auc_from_probs(test_y, probs_all, num_classes)

    if save:
        metrics.save_result(
            save + name, qbm, history, qbm.weight_objects(), test_y, predictions,
            class_names, batch_size, epochs, solver, learning_rate, save=True,
        )

    print("Accuracy: ", acc)
    print("F1 Score: ", f1)
    print("Precision: ", precision)
    print("Recall: ", recall)
    print("AUC Score: ", auc)
    return acc, f1, precision, recall, auc


def _seed_sweep(qbm, seeds, train_x, train_y, test_x, test_y, epochs, batch_size,
                learning_rate, save, name, class_names, reinit_on_collapse=0):
    """Every seed as ONE batched sweep (``SeedParallelCDQBM`` over the donor
    ``qbm``'s geometry and flags): per-epoch test metrics a seed, per-seed
    pickles and best-epoch weights (``_common.finish_seed_sweep``)."""
    sweep = SeedParallelCDQBM(seeds, qbm)
    hists = sweep.train(train_x, train_y, test_x, test_y, epochs=epochs,
                        batch_size=batch_size, learning_rate=learning_rate,
                        class_titles=tuple(class_names), verbose=True,
                        reinit_on_collapse=reinit_on_collapse)
    return finish_seed_sweep(sweep, seeds, hists, save, name)


def build_parser():
    p = argparse.ArgumentParser(description="Run Conv-Deep-QBM experiments (PyTorch / CUDA).")
    p.add_argument("-lr", "--learning_rate", type=float, default=0.01)
    p.add_argument("-r", "--restricted", type=str2bool, default=False)
    p.add_argument("-e", "--epochs", type=int, default=20)
    p.add_argument("-b", "--batch_size", type=int, default=3)
    p.add_argument("-s", "--seed", type=int, default=44)
    p.add_argument("-sc", "--sample_count", type=int, default=100)
    p.add_argument("--anneal", type=int, default=1000,
                   help="sweeps per read (SA anneal, BMS warm-up, PT sweeps)")
    p.add_argument("--solver", type=str, default="SA",
                   help="'SA' / 'SA-PALLAS', 'BMS', 'PT' -- each a CUDA kernel on a GPU; "
                        "'SA-JAX' / 'SA-TORCH' (plain PyTorch), 'SA-NATIVE' (C++ on the "
                        "host), 'EXACT', or a D-Wave solver name (needs the Ocean SDK)")
    p.add_argument("--data_set", type=str, default="mnist")
    p.add_argument("--num_classes", type=int, default=2)
    p.add_argument("--save", "--out", dest="save", type=str, default="out/")
    p.add_argument("--name", type=str, default="run")
    p.add_argument("--pooling_size", type=int, default=4,
                   help="Pooling window size (0/1 disables)")
    p.add_argument("--pooling_type", type=str, default="deterministic",
                   help="'probabilistic' or 'deterministic'")
    p.add_argument("--hidden_bias_type", type=str, default="shared",
                   help="'shared', 'none', or 'per-unit'")
    p.add_argument("--one_hot", action="store_true")
    p.add_argument("--parallelize", type=str2bool, default=False,
                   help="Kept for flag parity; chains always run batched on device")
    p.add_argument("--kernel_size", type=int, default=3)
    p.add_argument("--n_kernels", type=int, default=1,
                   help="conv channels (flag-gated capacity extension; 1 = reference parity)")
    p.add_argument("--stride", type=int, default=1)
    p.add_argument("--seq_sizes", type=int, nargs="*", default=[4])
    p.add_argument("--coreset_budget", type=int, default=0,
                   help="k-center coreset size (0 = use all training data)")
    p.add_argument("--progress", action="store_true",
                   help="tqdm bar over each epoch's batch loop")
    p.add_argument("--beta_eff", type=float, default=1.0,
                   help="effective inverse temperature divisor")
    p.add_argument("--samples_per_class", type=int, default=50,
                   help="per-class subsample for mnist/fashionmnist, applied to both splits")
    p.add_argument("--pool_select", type=str, default="min",
                   choices=["min", "max", "absmax"],
                   help="deterministic-pooling unit choice; 'min' is reference parity")
    p.add_argument("--center_fmap", type=str2bool, default=False,
                   help="zero-mean the conv feature map per image")
    p.add_argument("--signed_input", type=str2bool, default=False,
                   help="remap inputs to {-1,+1} before training")
    p.add_argument("--prob_penalty", type=float, default=0.8225,
                   help="probabilistic-pooling penalty strength")
    p.add_argument("--learn_penalty", type=str2bool, default=False,
                   help="learn a per-window probabilistic-pooling penalty vector "
                        "(init at --prob_penalty); needs probabilistic pooling")
    p.add_argument("--grad_clip", type=float, default=0.0,
                   help="max gradient global L2 norm (0 = off)")
    p.add_argument("--reinit_on_collapse", type=int, default=0,
                   help="with --seed_sweep: every N epochs re-draw each seed whose val "
                        "accuracy is stuck at the majority-class prediction")
    p.add_argument("--seed_sweep", type=int, nargs="+", default=None,
                   help="train ALL listed seeds as one batched sweep "
                        "(qbmx_torch.train.sweep.SeedParallelCDQBM); writes per-seed "
                        "per-epoch pickles and best_model/ checkpoints")
    p.add_argument("--checkpoint_every", type=int, default=0,
                   help="every N epochs write the full training state (params, "
                        "random stream, history, epoch) to <save><run>/state.npz; "
                        "needs --save")
    p.add_argument("--resume", type=str, default="",
                   help="continue from a --checkpoint_every state .npz, exactly")
    p.add_argument("--qpu_copies", type=int, default=1,
                   help="QPU solvers only: pack this many QUBO replicas into one "
                        "anneal (partition-aware placement on the chip)")
    p.add_argument("--qpu_embedding", choices=["first_party", "composite"],
                   default="first_party",
                   help="QPU solvers only: 'first_party' embeds with "
                        "qbmx_torch.embedding (one cached search per QUBO structure), "
                        "'composite' leaves it to Ocean's EmbeddingComposite")
    p.add_argument("--embedding_cache", type=str, default="",
                   help="QPU solvers only: directory for persisted embeddings "
                        "(qbmx's pickle format; reused across runs)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' needs a GPU (no CPU fallback)")
    return p


def run(argv=None):
    """Parse ``argv`` (the command line's by default) and call :func:`main`
    with it, as ``python -m qbmx_torch.cli.cdqbm_main`` does."""
    flags = build_parser().parse_args(argv)
    print("Running with solver", flags.solver)
    if flags.save:
        os.makedirs(flags.save, exist_ok=True)
    return main(
        seed=flags.seed, solver=flags.solver, sample_count=flags.sample_count,
        anneal=flags.anneal, beta_eff=flags.beta_eff, epochs=flags.epochs,
        batch_size=flags.batch_size, learning_rate=flags.learning_rate,
        restricted=flags.restricted, data_set=flags.data_set,
        num_classes=flags.num_classes, save=flags.save, name=flags.name,
        pooling_size=flags.pooling_size, pooling_type=flags.pooling_type,
        hidden_bias_type=flags.hidden_bias_type, one_hot=flags.one_hot,
        sequential_layer_sizes=flags.seq_sizes, kernel_size=flags.kernel_size,
        n_kernels=flags.n_kernels,
        stride=flags.stride, coreset_budget=flags.coreset_budget,
        samples_per_class=flags.samples_per_class,
        pool_select=flags.pool_select, center_fmap=flags.center_fmap,
        signed_input=flags.signed_input, prob_penalty=flags.prob_penalty,
        grad_clip=flags.grad_clip, progress=flags.progress,
        seed_sweep=flags.seed_sweep, reinit_on_collapse=flags.reinit_on_collapse,
        learn_penalty=flags.learn_penalty,
        checkpoint_every=flags.checkpoint_every, resume=flags.resume,
        qpu_copies=flags.qpu_copies, qpu_embedding=flags.qpu_embedding,
        embedding_cache=flags.embedding_cache, device=flags.device,
    )


if __name__ == "__main__":
    run()
