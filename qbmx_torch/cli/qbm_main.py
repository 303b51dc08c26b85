"""Flat Disc_QBM CLI on PyTorch — the flag set and defaults of
``qbmx.cli.qbm_main`` plus ``--device`` (default ``cuda``; a missing GPU
raises, the run never falls back to the CPU).

Solvers: ``SA`` (annealed Metropolis), ``BMS`` (annealed heat-bath, with
pair updates on the GPU) and ``PT`` (parallel tempering, 8 rungs), each
through its CUDA kernel on ``--device cuda`` and its plain PyTorch version
on ``--device cpu``; ``SA-TORCH`` and ``EXACT``.  ``--seed_sweep`` trains
every listed seed as one batched sweep (``train/sweep.SeedParallelDQBM``:
one sampler launch a step for all seeds).  ``--checkpoint_every N`` writes
the full training state every N epochs to ``<save><run>/state.npz``, and
``--resume <npz>`` continues from such a state exactly
(``utils/checkpoint.py``).  ``SA-NATIVE`` anneals on the host in C++
(``samplers/native.py``) on either device; a D-Wave solver name
(``Advantage*``, ``DW_*``) builds a QPU adapter through the Ocean SDK,
shaped by ``--qpu_copies``, ``--qpu_embedding`` and ``--embedding_cache``
(``samplers/qpu.py``).  ``--track_distribution`` records the per-epoch
output distribution in the history and, with ``--save``, draws it to
``<save><run>_distribution.png`` (needs matplotlib).
"""

from __future__ import annotations

import argparse
import random
import time

import numpy as np

from qbmx_torch.cli._common import (finish_seed_sweep, load_dataset, param_string,
                                    qpu_sampler_kwargs, str2bool)
from qbmx_torch.data import loaders
from qbmx_torch.models.base import resolve_device
from qbmx_torch.models.dqbm import DiscQBM
from qbmx_torch.train.loop import output_patterns, train_model
from qbmx_torch.train.sweep import SeedParallelDQBM
from qbmx_torch.utils import metrics, plots
from qbmx_torch.utils.checkpoint import load_checkpoint


def main(
    seed=19, n_hidden_nodes=10, solver="SA", sample_count=100, anneal=1000,
    beta_eff=1.0, epochs=3, batch_size=10, learning_rate=0.01, restricted=True,
    data_set="mnist", num_classes=2, parallelize=False, save="out/", name="run",
    use_one_hot_encoding=False, load_path="", progress=False, grad_clip=0.0,
    reinit_on_collapse=0, checkpoint_every=0, resume="", qpu_copies=1,
    qpu_embedding="first_party", embedding_cache="",
    seed_sweep=None, track_distribution=False, device="cuda",
):
    """Train, validate per epoch, predict on the test split; returns
    (acc, f1, precision, recall, auc), or with ``seed_sweep`` the per-seed
    best-epoch ``(accs, aucs)`` of one batched sweep over those seeds."""
    if seed_sweep and (resume or checkpoint_every):
        # qbmx's guards: silently ignoring these would lose checkpoints /
        # retrain from scratch while the user believes the flags took effect
        raise ValueError("--resume/--checkpoint_every need the "
                         "single-model path (omit --seed_sweep)")
    if seed_sweep and load_path:
        # every sweep seed re-derives its own init stream; a loaded
        # checkpoint would be silently discarded
        raise ValueError("--load_path needs the single-model path "
                         "(omit --seed_sweep)")
    if resume and load_path:
        # both set the initial params: the resumed state would silently
        # replace the loaded savepoint
        raise ValueError("--load_path and --resume both set initial "
                         "params; pass exactly one")
    dev = resolve_device(device)
    print("Start")
    random.seed(seed)
    np.random.seed(seed)
    print("Seed is", seed)

    print("Loading data...")
    (train_X, train_y), (val_X, val_y), (test_X, test_y) = load_dataset(
        data_set, seed=seed, num_classes=num_classes)
    train_X, test_X, val_X = loaders.preprocess_images(train_X, test_X, val_X)

    pstr = param_string(
        se=seed, h=n_hidden_nodes, sol=solver, sc=sample_count, b=beta_eff,
        e=epochs, bs=batch_size, l=learning_rate, r=restricted, data=data_set, n_=name,
    )
    print(pstr)

    class_titles = ["0", "1"] if num_classes == 2 else [str(i) for i in range(num_classes)]
    if seed_sweep:
        return _seed_sweep(
            seed_sweep, train_X, train_y, test_X, test_y,
            n_hidden_nodes=n_hidden_nodes, num_classes=num_classes,
            restricted=restricted, sample_count=sample_count, anneal=anneal,
            beta_eff=beta_eff, use_one_hot_encoding=use_one_hot_encoding,
            solver=solver, grad_clip=grad_clip, epochs=epochs,
            batch_size=batch_size, learning_rate=learning_rate, save=save,
            name=name, class_titles=class_titles,
            reinit_on_collapse=reinit_on_collapse, device=dev,
        )

    print(f"Creating QBM on {dev}...")
    dqbm = DiscQBM(
        dim_input=train_X.shape[1], num_classes=num_classes,
        n_hidden_nodes=n_hidden_nodes, seed=seed, solver=solver,
        restricted=restricted, sample_count=sample_count, anneal_steps=anneal,
        beta_eff=beta_eff, use_one_hot_encoding=use_one_hot_encoding,
        load_path=load_path, grad_clip=grad_clip,
        sampler_kwargs=qpu_sampler_kwargs(qpu_copies, qpu_embedding, embedding_cache),
        device=dev,
    )

    # full-state resume: parameters, random stream, history and completed
    # epochs, so the continued run equals an uninterrupted one
    start_epoch, prev_history = 0, None
    if resume:
        prev_history, start_epoch = load_checkpoint(resume, dqbm)
        print(f"Resumed full state from {resume} (completed epochs: {start_epoch})")
    if checkpoint_every and not save:
        # checkpoints land under the run folder; with no --save the flag
        # would silently do nothing
        raise ValueError("--checkpoint_every needs --save")
    ckpt_path = f"{save}{pstr}/state" if save and checkpoint_every else None

    print("Training QBM...")
    t0 = time.time()
    history = train_model(
        dqbm, train_X, train_y, test_X, test_y, batch_size=batch_size,
        learning_rate=learning_rate, epochs=epochs,
        save_folder=f"{save}{pstr}" if save else None,
        reinit_on_collapse=reinit_on_collapse, history=prev_history,
        checkpoint_every=checkpoint_every, checkpoint_path=ckpt_path,
        start_epoch=start_epoch, track_distribution=track_distribution, progress=progress,
    )
    print(f"QBM trained in {time.time() - t0:.1f}s")

    if track_distribution and save and history.distribution_per_epoch:
        # the bars of the reference's show_and_save_distribution
        # (src/metrics.py:131-167) over the per-epoch series
        plt = plots.pyplot()
        fig = plots.show_and_save_distribution(
            history.distribution_per_epoch,
            [f"e{i + 1}" for i in range(len(history.distribution_per_epoch))],
            f"{save}{pstr}_distribution.png", "Unclamped output distribution per epoch",
            output_patterns(dqbm), save=True)
        plt.close(fig)
        print(f"Distribution figure: {save}{pstr}_distribution.png")

    print("Predict on test data...")
    predictions, _ = dqbm.predict_batch(test_X)
    if save:
        acc, f1, precision, recall, auc = metrics.save_result(
            save + name, dqbm, history, dqbm.weight_objects(), test_y, predictions,
            class_titles, batch_size, epochs, solver, learning_rate,
        )
    else:
        acc, f1, precision, recall, auc = metrics.get_metrics(
            test_y, predictions, class_titles)
    print("Accuracy: ", acc)
    print("F1 Score: ", f1)
    print("Precision: ", precision)
    print("Recall: ", recall)
    print("AUC Score: ", auc)
    return acc, f1, precision, recall, auc


def _seed_sweep(seeds, train_X, train_y, test_X, test_y, *, n_hidden_nodes,
                num_classes, restricted, sample_count, anneal, beta_eff,
                use_one_hot_encoding, solver, grad_clip, epochs, batch_size,
                learning_rate, save, name, class_titles, reinit_on_collapse=0,
                device="cuda"):
    """Every seed as ONE batched sweep (``SeedParallelDQBM``): per-seed
    per-epoch pickles and reference-format best-epoch weights under
    ``best_model/`` (``_common.finish_seed_sweep``)."""
    sweep = SeedParallelDQBM(
        seeds, dim_input=train_X.shape[1], num_classes=num_classes,
        n_hidden_nodes=n_hidden_nodes, restricted=restricted,
        sample_count=sample_count, anneal_steps=anneal, beta_eff=beta_eff,
        use_one_hot_encoding=use_one_hot_encoding, solver=solver,
        grad_clip=grad_clip, device=device,
    )
    hists = sweep.train(train_X, train_y, test_X, test_y, epochs=epochs,
                        batch_size=batch_size, learning_rate=learning_rate,
                        class_titles=tuple(class_titles), verbose=True,
                        reinit_on_collapse=reinit_on_collapse)
    return finish_seed_sweep(sweep, seeds, hists, save, name)


def build_parser():
    p = argparse.ArgumentParser(description="Train/evaluate a flat discriminative QBM "
                                            "(PyTorch / CUDA).")
    p.add_argument("-hn", "--hnodes", metavar="INT", type=int, default=2,
                   help="Amount of hidden units")
    p.add_argument("-lr", "--learning_rate", metavar="FLOAT", type=float,
                   default=0.4529451796571889)
    p.add_argument("-r", "--restricted", type=str2bool, default=False,
                   help="No weights between hidden nodes")
    p.add_argument("-e", "--epochs", metavar="INT", type=int, default=20)
    p.add_argument("-b", "--batch_size", metavar="INT", type=int, default=73)
    p.add_argument("-s", "--seed", metavar="INT", type=int, default=3492574433)
    p.add_argument("-sc", "--sample_count", metavar="INT", type=int, default=100,
                   help="Number of samples (annealing reads) per QUBO")
    p.add_argument("--anneal", type=int, default=1000,
                   help="sweeps per read (SA anneal, BMS warm-up, PT sweeps)")
    p.add_argument("--solver", type=str, default="SA",
                   help="Solver: 'SA' / 'SA-PALLAS' (annealed Metropolis), 'BMS' "
                        "(annealed heat-bath), 'PT' (parallel tempering) -- each a "
                        "CUDA kernel on a GPU; 'SA-JAX' / 'SA-TORCH' (plain "
                        "PyTorch), 'SA-NATIVE' (C++ on the host), 'EXACT', or a "
                        "D-Wave solver name (needs the Ocean SDK)")
    p.add_argument("--data_set", type=str, default="pneumoniamnist",
                   help="'mnist', 'breastmnist', 'pneumoniamnist', 'fashionmnist', 'synthetic'")
    p.add_argument("--num_classes", type=int, default=2)
    p.add_argument("--one_hot", action="store_true",
                   help="Use one-hot label nodes (vs single binary node)")
    p.add_argument("--parallelize", type=str2bool, default=True,
                   help="Kept for flag parity; chains always run batched on device")
    p.add_argument("--load_path", type=str, default="",
                   help="Checkpoint pickle to initialize from")
    p.add_argument("--save", "--out", dest="save", type=str, default="out/")
    p.add_argument("--name", type=str, default="run")
    p.add_argument("--progress", action="store_true",
                   help="tqdm bar over each epoch's batch loop")
    p.add_argument("--beta_eff", type=float, default=1.0)
    p.add_argument("--grad_clip", type=float, default=0.0,
                   help="max gradient global L2 norm (0 = off)")
    p.add_argument("--reinit_on_collapse", type=int, default=0,
                   help="after N epochs, re-draw the params if val accuracy "
                        "is stuck at the majority-class prediction")
    p.add_argument("--checkpoint_every", type=int, default=0,
                   help="every N epochs write the full training state (params, "
                        "random stream, history, epoch) to <save><run>/state.npz; "
                        "needs --save")
    p.add_argument("--resume", type=str, default="",
                   help="continue from a --checkpoint_every state .npz, exactly")
    p.add_argument("--seed_sweep", type=int, nargs="+", default=None,
                   help="train ALL listed seeds as one batched sweep "
                        "(qbmx_torch.train.sweep.SeedParallelDQBM); writes per-seed "
                        "per-epoch pickles and best_model/ checkpoints")
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
    p.add_argument("--track_distribution", action="store_true",
                   help="record the unclamped output-node distribution per "
                        "epoch (History.distribution_per_epoch)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' needs a GPU (no CPU fallback)")
    return p


def run(argv=None):
    """Parse ``argv`` (the command line's by default) and call :func:`main`
    with it, as ``python -m qbmx_torch.cli.qbm_main`` does."""
    flags = build_parser().parse_args(argv)
    print("Running with solver", flags.solver)
    return main(
        epochs=flags.epochs, n_hidden_nodes=flags.hnodes,
        learning_rate=flags.learning_rate, batch_size=flags.batch_size,
        solver=flags.solver, restricted=flags.restricted, seed=flags.seed,
        data_set=flags.data_set, num_classes=flags.num_classes,
        parallelize=flags.parallelize, sample_count=flags.sample_count,
        anneal=flags.anneal, save=flags.save, name=flags.name,
        beta_eff=flags.beta_eff, use_one_hot_encoding=flags.one_hot,
        load_path=flags.load_path, progress=flags.progress,
        grad_clip=flags.grad_clip, reinit_on_collapse=flags.reinit_on_collapse,
        checkpoint_every=flags.checkpoint_every, resume=flags.resume,
        qpu_copies=flags.qpu_copies, qpu_embedding=flags.qpu_embedding,
        embedding_cache=flags.embedding_cache, seed_sweep=flags.seed_sweep,
        track_distribution=flags.track_distribution, device=flags.device,
    )


if __name__ == "__main__":
    run()
