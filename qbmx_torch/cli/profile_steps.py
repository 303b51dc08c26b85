"""Where a Disc_QBM or CDQBM training step's time goes, per solver.

    python -m qbmx_torch.cli.profile_steps                   # flagship width: h5 sc1000 bs60
    python -m qbmx_torch.cli.profile_steps --hidden 2 --reads 100 --batch 73   # CLI defaults
    python -m qbmx_torch.cli.profile_steps --cdqbm probabilistic --solver SA --reads 100
    python -m qbmx_torch.cli.profile_steps --cdqbm deterministic --solver SA --reads 100
    python -m qbmx_torch.cli.profile_steps --seed_sweep 0 1 2 3 4 5 6 7 8 9   # the 10-seed sweep
    python -m qbmx_torch.cli.profile_steps --seed_sweep 0 1 2 3 4 5 6 7 8 9 \
        --cdqbm probabilistic --solver SA --reads 100 --epochs 1   # the 10-seed CDQBM (a) sweep
    python -m qbmx_torch.cli.profile_steps --rbm                   # the RBM rows

For each solver: ``DiscQBM`` on the synthetic training split (600
images, 784 inputs) -- or with ``--cdqbm`` a ``CDQBM`` on the same images
at 28×28 in one of ``CDQBM_CONFIGS`` (the parity run's probabilistic
settings, or the CLI defaults, each with its own batch size; pass
``--reads 100``, their sample count), or with ``--seed_sweep`` a
``SeedParallelDQBM`` over those seeds at the flat widths, or with both a
``SeedParallelCDQBM`` in that configuration (one sampler launch a step
for every seed; ``ms_per_seed_step`` is a step ÷ seeds, against a single
model's ms/step) -- one warm-up epoch, then ``--epochs`` unprofiled
epochs timed on the host clock after ``synchronize()`` (their median,
divided by the steps, is ms/step), then one more epoch under
``torch.profiler`` (host events; on a GPU the device's too).  Its
``qbmx.*`` spans (``utils/spans.py``) give ``spans``, ``{name: [count,
total_ms, self_ms]}``, a span's self time being its time less the part
of it the spans inside it cover (``span_table``).  On a GPU its device
events give the device's busy time (the union of their intervals), the
solver kernel's time per launch and the device operations per step;
idle share = 1 − busy ÷ the median unprofiled epoch.  The kernels'
launch counters, zeroed just before that epoch and read just after
(``launch_counts``), name the kernel and path that served it
(``kernel``: K4's two shared paths and K5's two paths share a name
prefix in the profiler).  On ``--device cpu`` the device
columns are ``None``.

``--rbm`` times RBM epochs the same way (``profile_rbm``): CD-1
generative in bf16 on 65,536 binarized synthetic images at batch 4096
(16 steps an epoch) at H=128 (``bench.py``'s headline shape) and H=9 (its
reference shape), reported as ms an epoch and images/s; then
``rbm_main``'s defaults (discriminative, H=9, batch 7, f32) on the
synthetic split, one model and a 10-seed ``SeedParallelRBM``, each epoch
with its test predictions.

Prints one line per solver, then on a GPU the ``nvidia-smi`` name and
power limit, and last one JSON object with every record.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import time

import numpy as np
import torch

from qbmx_torch.cli._common import load_dataset
from qbmx_torch.data import loaders
from qbmx_torch.models.base import resolve_device
from qbmx_torch.models.cdqbm import CDQBM
from qbmx_torch.models.dqbm import DiscQBM
from qbmx_torch.samplers import launches
from qbmx_torch.samplers.kernel_call import fits_shared
from qbmx_torch.train.sweep import SeedParallelCDQBM, SeedParallelDQBM
from qbmx_torch.utils.spans import PREFIX as SPAN_PREFIX

#: the profiler's name prefix of the kernel each solver's sampler launches
#: on a GPU while the QUBO's couplings fit shared memory (above: "anneal_wide"
#: for SA and BMS, either path of K4's shared layout, and "pt_wide" for PT
#: at 8 rungs, either K5 path; the launch counters tell the paths apart)
SOLVER_KERNELS = {"SA": "sa_metropolis", "BMS": "sa_heatbath", "PT": "pt_heatbath"}
WIDE_KERNELS = {"SA": "anneal_wide", "BMS": "anneal_wide", "PT": "pt_wide"}
SEED, LEARNING_RATE = 19, 0.307  # the flagship run's learning rate
#: CDQBM settings: the probabilistic parity run (``out/parity/cdqbm_breast_prob.log``:
#: sc100 b5.0 bs20 l0.02) and ``cdqbm_main``'s defaults, both at pooling 4, --seq_sizes 4
CDQBM_CONFIGS = {
    "probabilistic": dict(model=dict(pooling_type="probabilistic", beta_eff=5.0),
                          batch=20, lr=0.02),
    "deterministic": dict(model=dict(pooling_type="deterministic", beta_eff=1.0),
                          batch=3, lr=0.01),
}


def solver_kernel(solver: str, n: int) -> str:
    """The kernel a solver's sampler launches on a GPU for an n-variable QUBO."""
    return SOLVER_KERNELS[solver] if fits_shared(n) else WIDE_KERNELS[solver]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _union_us(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -math.inf
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def span_table(events) -> dict:
    """``{name: [count, total_ms, self_ms]}`` of the program's spans
    (``qbmx.*``) among profiler events, by name; a span's self time is its
    time less the union of the spans that lie inside it."""
    spans = sorted((e.time_range.start, -e.time_range.end, e.name) for e in events
                   if e.name.startswith(SPAN_PREFIX))
    table = {}
    for i, (s, neg_e, name) in enumerate(spans):
        e = -neg_e
        inside = []
        for s2, neg_e2, _ in spans[i + 1:]:
            if s2 >= e:
                break
            if -neg_e2 <= e:
                inside.append((s2, -neg_e2))
        row = table.setdefault(name, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += (e - s) / 1e3
        row[2] += (e - s - _union_us(inside)) / 1e3
    return table


def device_breakdown(epoch, kernel: str | None, dev: torch.device) -> dict:
    """Run ``epoch()`` under ``torch.profiler`` and read its spans
    (``span_table``); on a GPU also its device events: busy ms (union), the
    operations, and ``kernel``'s launches and ms (none without a kernel);
    and the kernels' launch counters over it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    on_card = dev.type == "cuda"
    launches.reset()
    with profile(activities=[ProfilerActivity.CPU]
                 + ([ProfilerActivity.CUDA] if on_card else [])) as prof:
        epoch()
    counted = launches.counts()
    out = {"spans": span_table(prof.events())}
    if not on_card:
        return out
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        raise RuntimeError("torch.profiler recorded no device events: time the device "
                           "with CUDA events instead")
    spans = [(e.time_range.start, e.time_range.end) for e in events]
    mine = [e.time_range.elapsed_us() for e in events if kernel and kernel in e.name]
    out.update(busy_ms=_union_us(spans) / 1e3, device_ops=len(events),
               kernel_launches=len(mine), kernel_ms=sum(mine) / 1e3, launch_counts=counted)
    return out


def time_epochs(run, epochs: int, dev: torch.device, kernel: str | None = None):
    """``(median ms, every run's ms, breakdown)`` of epochs of ``run()``:
    one warm-up (first launches, device copies of the batches), ``epochs``
    timed on the host clock after ``synchronize()``, then one more under
    ``torch.profiler`` (``device_breakdown``: the spans, and on a GPU the
    device's columns)."""

    def epoch():
        run()
        _sync(dev)

    epoch()
    walls = []
    for _ in range(epochs):
        t0 = time.perf_counter()
        epoch()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls), walls, device_breakdown(epoch, kernel, dev)


def profile_solver(solver: str, train_X, train_y, *, hidden: int, reads: int, sweeps: int,
                   batch: int, epochs: int, dev: torch.device, cdqbm: str | None = None,
                   seeds: list[int] | None = None) -> dict:
    lr = LEARNING_RATE
    n = hidden + 1
    if cdqbm:
        cfg = CDQBM_CONFIGS[cdqbm]
        model = CDQBM(image_shape=(28, 28), seed=SEED, pooling_size=4,
                      sequential_layer_sizes=[4], hidden_bias_type="shared", solver=solver,
                      anneal=sweeps, sample_count=reads, device=dev, **cfg["model"])
        batch, lr, n = cfg["batch"], cfg["lr"], model.geo.n_total
    elif not seeds:
        model = DiscQBM(dim_input=train_X.shape[1], n_hidden_nodes=hidden, seed=SEED,
                        solver=solver, restricted=False, sample_count=reads,
                        anneal_steps=sweeps, device=dev)
    if seeds:
        sweep = (SeedParallelCDQBM(seeds, model) if cdqbm else
                 SeedParallelDQBM(seeds, dim_input=train_X.shape[1], n_hidden_nodes=hidden,
                                  solver=solver, restricted=False, sample_count=reads,
                                  anneal_steps=sweeps, device=dev))

        def run():
            sweep.train(train_X, train_y, epochs=1, batch_size=batch, learning_rate=lr,
                        verbose=False)
    else:
        def run():
            model.train_epoch(train_X, train_y, batch, lr)
    steps = math.ceil(len(train_X) / batch)
    kernel = solver_kernel(solver, n)
    wall, walls, d = time_epochs(run, epochs, dev, kernel)
    name = f"CDQBM {cdqbm}" if cdqbm else "DiscQBM"
    if seeds:
        name = f"{type(sweep).__name__} {len(seeds)} seeds" + (f" ({name})" if cdqbm else "")
    rec = {"solver": solver, "model": name, "n": n, "seeds": len(seeds) if seeds else 1,
           "kernel": kernel, "steps": steps,
           "epoch_ms": wall, "ms_per_step": wall / steps, "epoch_ms_runs": walls,
           "ms_per_seed_step": wall / steps / (len(seeds) if seeds else 1),
           "busy_ms": None, "idle_share": None, "ops_per_step": None,
           "kernel_ms_per_launch": None, "kernel_share": None, "kernel_launches": None,
           "launch_counts": None, "spans": d["spans"]}
    if "busy_ms" in d:
        if len(d["launch_counts"]) == 1:  # the path that served, by its own counter
            rec["kernel"] = next(iter(d["launch_counts"]))
        rec.update(launch_counts=d["launch_counts"], busy_ms=d["busy_ms"], idle_share=1.0 - d["busy_ms"] / wall,
                   ops_per_step=d["device_ops"] / steps,
                   kernel_launches=d["kernel_launches"], kernel_share=d["kernel_ms"] / wall,
                   kernel_ms_per_launch=d["kernel_ms"] / max(d["kernel_launches"], 1))
    return rec


RBM_IMAGES, RBM_BATCH, RBM_LR = 65536, 4096, 0.05  # bench.py's headline settings


def _rbm_record(run, epochs: int, steps: int, images: int, dev: torch.device) -> dict:
    wall, walls, d = time_epochs(run, epochs, dev)
    rec = {"steps": steps, "epoch_ms": wall, "epoch_ms_runs": walls,
           "ms_per_step": wall / steps, "images_per_s": images / (wall / 1e3),
           "busy_ms": None, "idle_share": None, "ops_per_step": None}
    if "busy_ms" in d:
        rec.update(busy_ms=d["busy_ms"], idle_share=1.0 - d["busy_ms"] / wall,
                   ops_per_step=d["device_ops"] / steps)
    return rec


def profile_rbm(epochs: int, dev: torch.device) -> list[dict]:
    """The RBM rows (module docstring): CD-1 bf16 at the benchmark's two
    shapes, then ``rbm_main``'s defaults single and as a 10-seed sweep."""
    from qbmx_torch.cli import rbm_main
    from qbmx_torch.models import rbm
    from qbmx_torch.train.sweep import SeedParallelRBM

    records = []
    x, y = loaders.synthetic_images(4096, shape=(28, 28), num_classes=2, seed=0)
    x = loaders.binarize(x.reshape(len(x), -1))
    reps = max(RBM_IMAGES // len(x), 1)
    nb = RBM_IMAGES // RBM_BATCH
    x, y = np.tile(x, (reps, 1))[:RBM_IMAGES], np.tile(y, reps)[:RBM_IMAGES]
    xb = torch.as_tensor(x.reshape(nb, RBM_BATCH, -1), device=dev, dtype=torch.bfloat16)
    yb = torch.as_tensor(y.reshape(nb, RBM_BATCH), device=dev)
    step = rbm.make_train_step(2, method="generative", cd_k=1, compute_dtype=torch.bfloat16)
    epoch_fn = rbm.make_epoch_scan(step)
    for hidden in (128, 9):
        gen = torch.Generator().manual_seed(0)
        params = rbm.init_params(gen, xb.shape[-1], hidden, 2, dev)
        dgen = torch.Generator(device=dev).manual_seed(1)
        state = {"params": params}

        def epoch():
            state["params"], _ = epoch_fn(state["params"], dgen, xb, yb, RBM_LR)

        rec = _rbm_record(epoch, epochs, nb, RBM_IMAGES, dev)
        records.append({"model": f"RBM CD-1 generative bf16 H={hidden} batch {RBM_BATCH}",
                        **rec})

    (train_X, train_y), (val_X, _), (test_X, test_y) = load_dataset("synthetic", seed=SEED)
    train_X, test_X, _ = loaders.preprocess_images(train_X, test_X, val_X)
    flags = rbm_main.build_parser().parse_args([])
    h, bs, lr, seeds = flags.hidden_units, flags.batch_size, flags.lr, rbm_main.DEFAULT_SEEDS
    single = rbm.ClassificationRBM(train_X.shape[1], h, learning_rate=lr, seed=SEED, device=dev)
    sweep = SeedParallelRBM(seeds, train_X.shape[1], h, learning_rate=lr, device=dev)
    n = len(train_X)
    for name, epoch, steps in (
        ("ClassificationRBM", lambda: single.train_rbm(
            train_X, train_y, 1, bs, test_x=test_X, test_y=test_y), -(-n // bs)),
        (f"SeedParallelRBM {len(seeds)} seeds", lambda: sweep.sweep(
            train_X, train_y, test_X, test_y, epochs=1, batch_size=bs), n // bs),
    ):
        rec = _rbm_record(epoch, epochs, steps, n, dev)
        records.append({"model": f"{name} discriminative f32 H={h} batch {bs} (rbm_main "
                                 "defaults)", **rec})
    return records


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--solver", nargs="+", default=["SA", "BMS", "PT"])
    p.add_argument("--hidden", type=int, default=5)
    p.add_argument("--reads", type=int, default=1000)
    p.add_argument("--sweeps", type=int, default=1000)
    p.add_argument("--batch", type=int, default=60)
    p.add_argument("--epochs", type=int, default=3, help="unprofiled epochs timed")
    p.add_argument("--device", default="cuda")
    p.add_argument("--cdqbm", choices=sorted(CDQBM_CONFIGS), default=None,
                   help="profile a CDQBM in this configuration instead of the DiscQBM")
    p.add_argument("--seed_sweep", type=int, nargs="+", default=None,
                   help="profile a seed sweep over these seeds (with --cdqbm: a "
                        "SeedParallelCDQBM) instead of a single model")
    p.add_argument("--rbm", action="store_true",
                   help="profile the RBM rows instead (profile_rbm)")
    a = p.parse_args(argv)
    dev = resolve_device(a.device)
    if a.rbm:
        records = profile_rbm(a.epochs, dev)
        for rec in records:
            print(f"{rec['model']} on {dev}: "
                  + ", ".join(f"{k} {v}" for k, v in rec.items() if k != "model"))
    else:
        (train_X, train_y), (val_X, _), (test_X, _) = load_dataset("synthetic", seed=SEED)
        train_X, _, _ = loaders.preprocess_images(train_X, test_X, val_X)
        records = []
        for solver in a.solver:
            rec = profile_solver(solver, train_X, np.asarray(train_y), hidden=a.hidden,
                                 reads=a.reads, sweeps=a.sweeps, batch=a.batch,
                                 epochs=a.epochs, dev=dev, cdqbm=a.cdqbm, seeds=a.seed_sweep)
            records.append(rec)
            shape = f"CDQBM {a.cdqbm}" if a.cdqbm else \
                f"h{a.hidden} sc{a.reads} anneal{a.sweeps} bs{a.batch}"
            if a.seed_sweep:
                shape += f" sweep of {len(a.seed_sweep)} seeds"
            print(f"{solver} {shape} on {dev}: "
                  + ", ".join(f"{k} {v}" for k, v in rec.items() if k not in ("solver",)))
    if dev.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout.strip().splitlines()[0])
    print(json.dumps({"device": str(dev), "records": records}))
    return records


if __name__ == "__main__":
    main()
