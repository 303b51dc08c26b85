"""The mesh's scenarios that only ``tests/test_torch_parallel.py`` runs,
beside those of ``qbmx_torch/parallel/dryrun.py``: each runs on every
rank of a spawned world (``dryrun.spawn(run_all, ...)``), in one order on
all of them, and returns numpy results for the tests to read.  Like the
dryrun it imports torch and numpy only, so the spawned ranks never load
jax or ``qbmx``; they import it by name from this directory.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from qbmx_torch.parallel import dryrun
from qbmx_torch.parallel.dryrun import (
    cdqbm_model,
    dqbm_model,
    param_arrays,
    sharded_step,
    toy_batch,
)


def cdqbm_sweeps(device, dp: int, seeds: int = 4) -> dict:
    """The seed-sharded CDQBM sweep (the small CDQBM of :func:`cdqbm_model`
    under the plain anneal, 16 images, batch 8, one epoch, validation in
    chunks of 7) and the same sweep on this rank alone."""
    from qbmx_torch.models import cdqbm
    from qbmx_torch.parallel.mesh import make_mesh
    from qbmx_torch.samplers.api import SASampler
    from qbmx_torch.train.sweep import SeedParallelCDQBM

    mesh = make_mesh(dp=dp, chains=1, device=device)
    donor = cdqbm_model(mesh.device, sample_count=16,
                        sampler=SASampler(num_sweeps=6, use_kernel=False))
    rng = np.random.default_rng(6)
    x = rng.uniform(0, 1, (16, 4, 4)).astype("float32")
    y = rng.integers(0, 2, 16).astype("float32")
    out = {}
    for name, m in (("sharded", mesh), ("unsharded", None)):
        sw = SeedParallelCDQBM(list(range(seeds)), donor, mesh=m)
        hs = sw.train(x, y, x, y, epochs=1, batch_size=8, learning_rate=0.2, verbose=False,
                      predict_chunk=7)
        out[name] = ([h.acc_per_epoch for h in hs], cdqbm.params_to_numpy(sw.params))
    return out


def mesh_shapes(device) -> dict:
    """The shapes of (2, 2) and (chains=2) meshes on four ranks and the
    errors of two factorisations that do not fit."""
    from qbmx_torch.parallel.mesh import make_mesh

    out = {"2x2": make_mesh(dp=2, chains=2, device=device).shape,
           "chains=2": make_mesh(chains=2, device=device).shape}
    for dp in (3, 5):
        try:
            make_mesh(dp=dp, chains=2, device=device)
            out[f"dp={dp}"] = None
        except ValueError as e:
            out[f"dp={dp}"] = str(e)
    out["coords"] = make_mesh(dp=2, chains=2, device=device).coords
    return out


def step_runs(device, family: str, dp: int = 2, chains: int = 2) -> dict:
    """One sharded step under the heat-bath sampler (``qbmx``'s
    ``test_step_runs*`` models): the parameters before and after, the nll."""
    from qbmx_torch.parallel.mesh import make_mesh
    from qbmx_torch.samplers.api import GibbsSampler

    mesh = make_mesh(dp=dp, chains=chains, device=device)
    if family == "dqbm":
        model = dqbm_model(mesh.device, dim_input=6, n_hidden_nodes=3, sample_count=64,
                           sampler=GibbsSampler(num_warmup=8))
        x, y = toy_batch(0, 8, (6,))
    elif family == "dqbm784":
        model = dqbm_model(mesh.device, dim_input=784, n_hidden_nodes=8, sample_count=64,
                           sampler=GibbsSampler(num_warmup=8))
        x, y = toy_batch(1, 64, (784,))
    else:
        model = cdqbm_model(mesh.device, sample_count=32, sampler=GibbsSampler(num_warmup=4),
                            image_shape=(6, 6), pooling_size=2, pooling_type="deterministic",
                            sequential_layer_sizes=[3])
        x, y = toy_batch(3, 8, (6, 6))
    params, nll, _ = sharded_step(mesh, model, x, y, torch.ones(x.shape[0]), 0.3)
    return {"before": param_arrays(model), "after": params, "nll": nll}


def masked_tail(device, dp: int = 2, chains: int = 2) -> tuple:
    """A sharded step (exact sampler, 2048 reads) on a batch whose masked
    tail is poisoned, and on the clean batch, from one model and stream."""
    from qbmx_torch.parallel.mesh import make_mesh

    mesh = make_mesh(dp=dp, chains=chains, device=device)
    model = dqbm_model(mesh.device, sample_count=2048)
    x, y = toy_batch(2, 8, (4,))
    poisoned = x.clone()
    poisoned[6:] = 123.0
    mask = torch.tensor([1, 1, 1, 1, 1, 1, 0, 0], dtype=torch.float32)
    return (sharded_step(mesh, model, x, y, mask, 0.5)[0],
            sharded_step(mesh, model, poisoned, y, mask, 0.5)[0])


def grad_clip(device, dp: int = 4) -> dict:
    """The update norm of one sharded step (exact sampler, 256 reads, lr 1)
    without clipping and clipped at 1e-3."""
    from qbmx_torch.parallel.mesh import make_mesh

    mesh = make_mesh(dp=dp, chains=1, device=device)
    x, y = toy_batch(2, 8, (4,))
    out = {}
    for clip in (0.0, 1e-3):
        model = dqbm_model(mesh.device, sample_count=256, grad_clip=clip)
        after = sharded_step(mesh, model, x, y, torch.ones(8), 1.0)[0]
        out[clip] = float(np.sqrt(sum(((a - b) ** 2).sum()
                                      for a, b in zip(after, param_arrays(model)))))
    return out


def shard_model_trains(device, dp: int = 4) -> dict:
    """``shard_model`` on a small probabilistic-pooling CDQBM, then two
    epochs of ``train.loop.train_model`` (16 images, batch 8): the nll
    series and the final parameters (replicated: equal on every rank)."""
    from qbmx_torch.parallel.mesh import make_mesh, shard_model
    from qbmx_torch.samplers.api import GibbsSampler
    from qbmx_torch.train.loop import train_model

    mesh = make_mesh(dp=dp, chains=1, device=device)
    model = cdqbm_model(mesh.device, sample_count=16, sampler=GibbsSampler(num_warmup=4),
                        seed=1, pooling_size=2, pooling_type="probabilistic")
    shard_model(model, mesh)
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, (16, 4, 4)).astype("float32")
    y = rng.integers(0, 2, 16).astype("float32")
    h = train_model(model, x, y, x, y, batch_size=8, learning_rate=0.2, epochs=2,
                    verbose=False)
    return {"nll_per_epoch": h.nll_per_epoch, "acc_per_epoch": h.acc_per_epoch,
            "params": param_arrays(model)}


def refusals(device) -> dict:
    """The errors of seed counts that do not divide over dp (the DQBM and
    RBM sweeps) and of a batch that does not divide over dp."""
    from qbmx_torch.parallel.mesh import make_mesh
    from qbmx_torch.samplers.api import SASampler
    from qbmx_torch.train.sweep import SeedParallelDQBM, SeedParallelRBM

    out = {}
    mesh = make_mesh(dp=2, chains=1, device=device)
    for name, make in (
            ("dqbm_sweep", lambda: SeedParallelDQBM(
                [0, 1, 2], dim_input=4, n_hidden_nodes=2, device=mesh.device, mesh=mesh,
                sampler=SASampler(num_sweeps=2, use_kernel=False))),
            ("rbm_sweep", lambda: SeedParallelRBM(list(range(6)), 12, 3, device=mesh.device,
                                                  mesh=make_mesh(dp=4, device=device))),
            ("batch", lambda: sharded_step(make_mesh(dp=4, device=device),
                                           dqbm_model(mesh.device, sample_count=8),
                                           *toy_batch(0, 7, (4,)), torch.ones(7), 0.1))):
        try:
            make()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def writes(device, root: str, dp: int = 4) -> dict:
    """A sharded ``DiscQBM`` trained by ``train_model`` with weight pickles,
    histories and checkpoints, and a seed-sharded sweep's best-model
    pickles, every rank pointed at a folder of its own under ``root``:
    what each rank's folder holds afterwards."""
    from qbmx_torch.parallel.mesh import make_mesh, shard_model
    from qbmx_torch.samplers.api import SASampler
    from qbmx_torch.train.loop import train_model
    from qbmx_torch.train.sweep import SeedParallelDQBM

    mesh = make_mesh(dp=dp, chains=1, device=device)
    mine = os.path.join(root, f"rank{mesh.rank}")
    model = shard_model(dqbm_model(mesh.device, sample_count=8,
                                   sampler=SASampler(num_sweeps=3, use_kernel=False)), mesh)
    x, y = toy_batch(7, 16, (4,))
    train_model(model, x.numpy(), y.numpy(), x.numpy(), y.numpy(), batch_size=8, epochs=1,
                save_folder=os.path.join(mine, "model"), checkpoint_every=1,
                checkpoint_path=os.path.join(mine, "model", "state.npz"), verbose=False)
    sw = SeedParallelDQBM(list(range(dp)), dim_input=4, n_hidden_nodes=2, sample_count=8,
                          device=mesh.device, mesh=mesh,
                          sampler=SASampler(num_sweeps=3, use_kernel=False))
    sw.train(x.numpy(), y.numpy(), x.numpy(), y.numpy(), epochs=1, verbose=False)
    paths = sw.save_best_models(os.path.join(mine, "sweep"))
    files = sorted(os.path.relpath(os.path.join(d, f), mine)
                   for d, _, fs in os.walk(mine) for f in fs) if os.path.isdir(mine) else []
    return {"rank": mesh.rank, "files": files, "paths": paths}


def run_all(device, calls) -> list:
    """Each ``(name, kwargs)`` of ``calls`` — scenario functions of this
    module or of ``dryrun``, called ``name(device, **kwargs)`` — in order;
    their results."""
    return [(globals().get(name) or getattr(dryrun, name))(device, **kw) for name, kw in calls]
