"""Multi-rank dryrun of the mesh, asserting equalities:

    python -m qbmx_torch.parallel.dryrun --world N [--device cpu|cuda] [--backend gloo|nccl]

spawns N ranks (one process each) over one process group and, on every
rank, holds the mesh to the single-device code:

  * one sharded step of each family (``DiscQBM``, ``CDQBM``) at small
    widths under the exact sampler against the single model's step from
    the same parameters: parameters within 0.05, nll within 0.2
    (``qbmx``'s ``tests/test_parallel.py`` tolerances);
  * the seed-sharded RBM sweep against the unsharded one, bit for bit;
  * the seed-sharded DQBM sweep (the plain anneal) against the unsharded
    one: parameters within 1e-5, equal accuracy lists.

The device is the CPU (gloo) or the card (NCCL, one rank a card; gloo to
put several ranks on one card).  Nothing here imports jax or ``qbmx``, so
the spawned ranks never do.  :func:`spawn` and the scenarios here are also
what ``tests/test_torch_parallel.py`` runs (beside its own, in
``tests/torch_mesh_scenarios.py``), and :func:`flagship_pair` is
``chip_smoke.py``'s two ranks on one card.
"""

from __future__ import annotations

import argparse
import copy
import datetime
import os
import pickle
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

STEP_ATOL, NLL_ATOL = 0.05, 0.2  # qbmx's sharded-vs-single bars (exact sampler)
# the flagship step over two ranks on the card against the unsharded step,
# set from its readings (parameters 8.7e-5 apart, nll 0.0, on an H100)
PAIR_ATOL, PAIR_NLL_ATOL = 1e-3, 1e-2
SWEEP_ATOL = 1e-5  # qbmx's seed-sharded DQBM sweep bar


# ---------------------------------------------------------------------------
# Spawning ranks
# ---------------------------------------------------------------------------


def _rank_main(fn, rank: int, world: int, backend: str, init: str, timeout: float,
               out_dir: str, args: tuple) -> None:
    torch.set_num_threads(1)
    try:
        dist.init_process_group(backend, init_method=init, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)


def spawn(fn, world: int, backend: str = "gloo", args: tuple = (), timeout: float = 300.0):
    """``fn(*args)`` in ``world`` spawned ranks of one process group
    (``file://`` rendezvous in a fresh directory, so concurrent runs never
    share a port); returns each rank's result.  ``fn`` is a module-level
    function.  A rank still running ``timeout`` seconds after the start is
    killed and the call raises ``TimeoutError``; a rank that failed makes it
    raise ``RuntimeError`` with its traceback.  The process group's own
    timeout is the same, so a collective that never completes fails its
    rank instead of hanging it."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{os.path.join(tmp, 'rendezvous')}"
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, backend, init, timeout, tmp, args))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout + 30.0
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10.0)
        errors = []
        for r, p in enumerate(procs):
            err = os.path.join(tmp, f"rank{r}.err")
            if os.path.exists(err):
                with open(err) as f:
                    errors.append(f"rank {r}:\n{f.read()}")
            elif p.exitcode != 0 and r not in hung:
                errors.append(f"rank {r}: exit code {p.exitcode}")
        if hung:
            raise TimeoutError(f"ranks {hung} of {world} still running after {timeout} s"
                               + "".join("\n" + e for e in errors))
        if errors:
            raise RuntimeError("\n".join(errors))
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def _no_jax() -> bool:
    return not any(m in ("jax", "qbmx") or m.startswith(("jax.", "qbmx."))
                   for m in sys.modules)


# ---------------------------------------------------------------------------
# Scenarios: each runs on every rank, in one order on all of them
# ---------------------------------------------------------------------------


def toy_batch(seed: int, B: int, shape: tuple):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.uniform(0, 1, (B,) + shape).astype(np.float32))
    y = torch.as_tensor(rng.integers(0, 2, B).astype(np.float32))
    return x, y


def param_arrays(model) -> list[np.ndarray]:
    from qbmx_torch.models.base import tree_leaves

    return [leaf.detach().cpu().numpy() for leaf in tree_leaves(model.params)]


def dqbm_model(device, *, dim_input=4, n_hidden_nodes=2, sample_count=4096, sampler=None,
               init=None, **kw):
    """A ``DiscQBM`` (seed 0) on ``device``, under the exact sampler unless
    given one; ``init``: its parameters as the six numpy fields."""
    from qbmx_torch.models.dqbm import DiscQBM, params_from_numpy
    from qbmx_torch.samplers.api import ExactSampler

    m = DiscQBM(dim_input=dim_input, n_hidden_nodes=n_hidden_nodes, seed=0,
                sample_count=sample_count, restricted=False,
                sampler=sampler if sampler is not None else ExactSampler(), device=device, **kw)
    if init is not None:
        m.params = params_from_numpy(init, device)
    return m


def cdqbm_model(device, *, sample_count=4096, sampler=None, **kw):
    """A small ``CDQBM`` (4×4 images, kernel 3, one sequential layer of 2:
    7 variables) on ``device``, under the exact sampler unless given one."""
    from qbmx_torch.models.cdqbm import CDQBM
    from qbmx_torch.samplers.api import ExactSampler

    geo = dict(image_shape=(4, 4), num_label_nodes=1, seed=0, kernel_size=3, pooling_size=0,
               sequential_layer_sizes=[2], hidden_bias_type="shared")
    geo.update(kw)
    return CDQBM(sample_count=sample_count, device=device,
                 sampler=sampler if sampler is not None else ExactSampler(), **geo)


def sharded_step(mesh, model, x, y, mask, lr):
    """One sharded step of ``model`` (a copy: the model is left as it was);
    returns ``(params, nll, err)`` as numpy."""
    from qbmx_torch.parallel.mesh import shard_model

    m = shard_model(copy.deepcopy(model), mesh)
    dev = mesh.device
    nll, err = m._step(x.to(dev), y.to(dev), mask.to(dev), lr)
    return param_arrays(m), float(nll), float(err)


def single_step(model, x, y, mask, lr):
    """The single model's step on a copy; returns ``(params, nll, err)``."""
    m = copy.deepcopy(model)
    dev = m.device
    nll, err = m._step(x.to(dev), y.to(dev), mask.to(dev), lr)
    return param_arrays(m), float(nll), float(err)


def step_against_single(device, dp: int, chains: int, family: str, init=None) -> dict:
    """A sharded step of ``family`` ("dqbm" / "cdqbm") on a (dp, chains)
    mesh against the single model's step, both under the exact sampler at
    4096 reads from the same parameters (``init``: the DQBM's as numpy);
    returns both, the initial parameters and the largest difference."""
    from qbmx_torch.parallel.mesh import make_mesh

    mesh = make_mesh(dp=dp, chains=chains, device=device)
    B = 4 * dp
    if family == "dqbm":
        model = dqbm_model(mesh.device, init=init)
        x, y = toy_batch(1, B, (4,))
    else:
        model = cdqbm_model(mesh.device)
        x, y = toy_batch(5, B, (4, 4))
    mask = torch.ones(B)
    out = {"init": param_arrays(model)}
    if mesh.coords is None:
        return out
    out["sharded"] = sharded_step(mesh, model, x, y, mask, 0.5)
    out["single"] = single_step(model, x, y, mask, 0.5)
    out["max_diff"] = max(float(np.abs(a - b).max())
                          for a, b in zip(out["sharded"][0], out["single"][0]))
    out["nll_diff"] = abs(out["sharded"][1] - out["single"][1])
    return out


def rbm_sweeps(device, dp: int, seeds: int = 8, method: str = "discriminative",
               epochs: int = 3, unsharded: bool = True) -> dict:
    """The seed-sharded RBM sweep (``seeds`` seeds over dp ranks, 24 × 12
    inputs, H=3, batch 6) and, with ``unsharded``, the same sweep on this
    rank alone: their accuracy and AUC lists and final parameters."""
    from qbmx_torch.models import rbm
    from qbmx_torch.parallel.mesh import make_mesh
    from qbmx_torch.train.sweep import SeedParallelRBM

    mesh = make_mesh(dp=dp, chains=1, device=device)
    rng = np.random.default_rng(9)
    x = rng.uniform(0, 1, (24, 12)).astype("float32")
    y = rng.integers(0, 2, 24)
    tx = rng.uniform(0, 1, (10, 12)).astype("float32")
    ty = rng.integers(0, 2, 10)
    kw = dict(method=method, device=mesh.device)
    if method != "discriminative":
        kw["generative_factor"] = 0.5
    out = {}
    runs = (("sharded", mesh), ("unsharded", None)) if unsharded else (("sharded", mesh),)
    for name, m in runs:
        sw = SeedParallelRBM(list(range(seeds)), 12, 3, mesh=m, **kw)
        acc, auc = sw.sweep(x, y, tx, ty, epochs=epochs, batch_size=6)
        out[name] = (acc, auc, list(rbm.params_to_numpy(sw.params).values()),
                     sw.best_epoch.tolist())
    return out


def dqbm_sweeps(device, dp: int, seeds: int = 8, epochs: int = 2, unsharded: bool = True,
                reinit: tuple = ()) -> dict:
    """The seed-sharded DQBM sweep (the plain anneal, 8 sweeps, 32 reads;
    48 × 6 inputs, batch 16, validation on the training set) and, with
    ``unsharded``, the same sweep on this rank alone; ``reinit``: seeds (by
    index) re-drawn with attempt 1 before training.  Returns per-seed
    accuracy lists, final parameters and best epochs."""
    from qbmx_torch.models.dqbm import params_to_numpy
    from qbmx_torch.parallel.mesh import make_mesh
    from qbmx_torch.samplers.api import SASampler
    from qbmx_torch.train.sweep import SeedParallelDQBM

    mesh = make_mesh(dp=dp, chains=1, device=device)
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 1, (48, 6)).astype("float32")
    y = (x[:, 0] > 0.5).astype("float32")
    out = {}
    runs = (("sharded", mesh), ("unsharded", None)) if unsharded else (("sharded", mesh),)
    for name, m in runs:
        sw = SeedParallelDQBM(list(range(seeds)), dim_input=6, n_hidden_nodes=3,
                              sample_count=32, device=mesh.device, mesh=m,
                              sampler=SASampler(num_sweeps=8, use_kernel=False))
        if reinit:
            sw.reinit_seeds(list(reinit))
        redrawn = params_to_numpy(sw.params)
        hs = sw.train(x, y, x, y, epochs=epochs, batch_size=16, learning_rate=0.2,
                      verbose=False)
        out[name] = ([h.acc_per_epoch for h in hs], params_to_numpy(sw.params),
                     sw.best_epoch.tolist(), redrawn, [h.nll_per_batch for h in hs])
    return out


def _event_ms(fn, runs: int) -> list[float]:
    """``fn()`` timed by CUDA events, ``runs`` times after a warm-up (ms)."""
    fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def _max_diff(a, b) -> float:
    from qbmx_torch.models.base import tree_leaves

    return max(float((u - v).abs().max()) for u, v in zip(tree_leaves(a.params),
                                                           tree_leaves(b.params)))


def flagship_pair(device, root: str, dp: int = 2, steps: int = 2, reads: int = 1000,
                  sweeps: int = 1000) -> dict:
    """On the card, ``dp`` ranks of one gloo group: the flagship DQBM (784
    inputs, H=5, 1000 reads, 1000 sweeps, batch 60, SA on K1) sharded over
    dp against the unsharded step from the same parameters, and the control
    (the rank's step with the all-reduce left out: its own rows alone),
    each rank's launches of that step, both steps timed; then the 10-seed
    flagship sweep over dp (``steps`` steps and one validation call, each
    rank a folder of its own under ``root`` for the best-model pickles) and
    its launches; then one hot K1 launch of the same problems from the
    sweep's stream on every rank (``probe``: the ranks' launch seeds must
    differ) and the sweep generator's state after it.  ``reads``,
    ``sweeps``: the flagship's unless cut.  Returns the rank's record."""
    from qbmx_torch.models.dqbm import DiscQBM, StepSeams
    from qbmx_torch.parallel.mesh import MeshSeams, make_mesh, shard_model
    from qbmx_torch.samplers import launches, sa_cuda
    from qbmx_torch.train.sweep import SeedParallelDQBM

    class RowsOnly(MeshSeams):
        reduce = StepSeams.reduce

    mesh = make_mesh(dp=dp, chains=1, device=device)
    dev = mesh.device
    rng = np.random.default_rng(21)
    x = torch.as_tensor(rng.random((60, 784), dtype=np.float32), device=dev)
    y = torch.as_tensor(np.arange(60) % 2, device=dev)
    mask = torch.ones(60, device=dev)
    base = DiscQBM(dim_input=784, n_hidden_nodes=5, sample_count=reads, anneal_steps=sweeps,
                   solver="SA", device=dev)
    sharded = shard_model(copy.deepcopy(base), mesh)
    single, control = copy.deepcopy(base), copy.deepcopy(base)
    launches.reset()
    nll_s, _ = sharded._step(x, y, mask, 0.307)
    torch.cuda.synchronize(dev)
    rec = {"rank": mesh.rank, "step_launches": launches.counts()}
    nll_u, _ = single._step(x, y, mask, 0.307)
    nll_c, _ = control._step(x, y, mask, 0.307, RowsOnly(mesh))
    rec["max_diff"] = _max_diff(sharded, single)
    rec["nll_diff"] = abs(float(nll_s) - float(nll_u))
    rec["control_diff"] = _max_diff(control, single)
    rec["control_nll_diff"] = abs(float(nll_c) - float(nll_u))
    rec["sharded_ms"] = _event_ms(lambda: sharded._step(x, y, mask, 0.307), 5)
    rec["single_ms"] = _event_ms(lambda: single._step(x, y, mask, 0.307), 5)
    X = rng.random((60 * steps, 784), dtype=np.float32)
    Y = np.arange(60 * steps) % 2
    sw = SeedParallelDQBM(list(range(10)), dim_input=784, n_hidden_nodes=5, sample_count=reads,
                          anneal_steps=sweeps, device=dev, mesh=mesh)
    launches.reset()
    hs = sw.train(X, Y, X[:60], Y[:60], epochs=1, batch_size=60, learning_rate=0.307,
                  verbose=False)
    torch.cuda.synchronize(dev)
    rec["sweep_launches"] = launches.counts()
    rec["sweep_nll_finite"] = bool(np.isfinite([h.nll_per_batch for h in hs]).all())
    mine = os.path.join(root, f"rank{mesh.rank}")
    sw.save_best_models(mine)
    rec["files"] = sorted(os.listdir(os.path.join(mine, "best_model"))) \
        if os.path.isdir(os.path.join(mine, "best_model")) else []
    # the same 5 groups on every rank, annealed hot (beta 0.01: samples near
    # uniform) from the sweep's stream: equal launch seeds give equal samples
    g = torch.Generator().manual_seed(23)
    Q = torch.randn((len(sw.rows), 6, 6), generator=g).triu().to(dev)
    h = torch.randn((len(sw.rows), 4, 6), generator=g).to(dev)
    probe = sa_cuda.sa_sample_groups_cuda(Q, h, 16, 10, generator=sw._stream(1),
                                          beta_hot=0.01, beta_cold=0.01)
    rec["probe"] = probe.to(torch.uint8).cpu().numpy()
    rec["generator_state"] = sw.generator.get_state().numpy().tobytes()
    return rec


# ---------------------------------------------------------------------------
# The dryrun
# ---------------------------------------------------------------------------


def _tree_diff(a, b) -> float:
    if isinstance(a, dict):
        return max(_tree_diff(a[k], b[k]) for k in a if a[k] is not None)
    if isinstance(a, (list, tuple)):
        return max(_tree_diff(u, v) for u, v in zip(a, b))
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def check_world(device: str) -> dict:
    """Every rank: the dryrun's checks (module docstring); raises
    ``AssertionError`` on the first that fails, returns the measured
    differences."""
    assert _no_jax(), "a rank imported jax or qbmx"
    world = dist.get_world_size()
    chains = 2 if world % 2 == 0 else 1
    rep = {"rank": dist.get_rank(), "world": world, "backend": dist.get_backend()}
    for family in ("dqbm", "cdqbm"):
        r = step_against_single(device, world // chains, chains, family)
        assert r["max_diff"] <= STEP_ATOL, f"{family}: sharded step {r['max_diff']} from single"
        assert r["nll_diff"] < NLL_ATOL, f"{family}: nll {r['nll_diff']} from single"
        rep[family] = {"mesh": (world // chains, chains), "max_diff": r["max_diff"],
                       "nll_diff": r["nll_diff"]}
    r = rbm_sweeps(device, world, seeds=2 * world)
    a, b = r["sharded"], r["unsharded"]
    assert a[0] == b[0] and a[1] == b[1], "RBM sweep: accuracy/AUC lists differ"
    assert all(np.array_equal(u, v) for u, v in zip(a[2], b[2])), "RBM sweep: parameters differ"
    rep["rbm_sweep"] = "bit for bit"
    r = dqbm_sweeps(device, world, seeds=2 * world)
    a, b = r["sharded"], r["unsharded"]
    diff = _tree_diff(a[1], b[1])
    assert diff <= SWEEP_ATOL and a[0] == b[0], f"DQBM sweep: parameters {diff} apart"
    rep["dqbm_sweep"] = diff
    return rep


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                    help="default: nccl on the card (one rank a card), gloo on the CPU")
    ap.add_argument("--timeout", type=float, default=300.0)
    a = ap.parse_args(argv)
    if a.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available (pass --device cpu)")
    backend = a.backend or ("nccl" if a.device == "cuda" else "gloo")
    if backend == "nccl" and a.world > torch.cuda.device_count():
        raise SystemExit(f"NCCL takes one rank a card: --world {a.world} on "
                         f"{torch.cuda.device_count()} card(s); pass --backend gloo")
    device = "cuda:0" if a.device == "cuda" and backend == "gloo" else a.device
    t0 = time.perf_counter()
    reps = spawn(check_world, a.world, backend, (device,), a.timeout)
    assert _no_jax(), "the dryrun imported jax or qbmx"
    for rep in reps:
        print(rep)
    print(f"dryrun: world {a.world} on {a.device} over {backend}: every check passed in "
          f"{time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
