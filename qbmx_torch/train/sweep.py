"""Seed-parallel training: S models, one per seed, trained as one batched
program (counterparts of ``qbmx.train.sweep.SeedParallelDQBM``,
``SeedParallelCDQBM`` and ``SeedParallelRBM``).

The parameters are one parameter tree stacked over a leading seed axis.
Each step is ONE structured sampler call over 2·S groups of B problems --
every seed's clamped group first, then every seed's unclamped group, as
``qbmx`` orders them -- so at the 10-seed flagship (H=5, batch 60, 1000
reads) a step is one launch of 20 groups of 60 problems, and at the
10-seed CDQBM (a) (n=717, batch 20, 100 reads) one of 20 groups of 20.
The QUBO builders take the stacked parameters (``models/dqbm.py``,
``models/cdqbm.py``); the moments are the single model's functions over
the seeds × examples; the masked mean, clipping and update are batched
over the seed axis.  An epoch is a Python loop of steps whose nlls stay on
the device until its end: one host sync an epoch.

Streams: seed s's parameters come from ``qbmx``'s threefry key for ``(s,
attempt)`` (``core/threefry.init_key``), as ``DiscQBM(seed=s)`` and
``CDQBM(seed=s)`` draw their own and as ``qbmx``'s sweeps draw theirs, so
its initial parameters are equal to both.  The samplers' random numbers come from one
sweep-level generator, a pure function of the seed list: the kernels key
their Philox streams per problem from its draws, so a seed's samples do
not depend on its batch-mates, but they do not reproduce a single-model
run's stream either (neither does ``qbmx``'s packed route).

The RBM sweep (:class:`SeedParallelRBM`) runs no sampler: its products are
batched matmuls over the seed axis (``models/rbm.py``), and its epoch
drops the ragged tail, as ``qbmx``'s does.

``mesh=`` (a ``parallel.mesh.Mesh``) shards the seed axis over dp: each
rank trains its S/dp seeds (``mesh.seed_rows``; the seed count must
divide) and the rows are gathered when a run ends, so every rank returns
every seed's history and holds every seed's parameters and best epoch;
rank 0 alone writes the pickles.  A rank's sampler calls and the RBM's
shuffles and chain draws take its rows of the whole sweep's draws
(``core.rng.RowStream``): on the plain versions (the CPU) the sharded
sweep reproduces the unsharded one, and bit for bit for the RBM, whose
draws are all its own.  The kernels key Philox by a group's index within
the launch, which every rank shares, so a rank's launch seed is folded
with its first row (``RowStream.seed``): every seed of the sweep anneals
from numbers of its own, and on the card a sharded sweep of more than one
rank agrees with the unsharded one statistically, not bit for bit (at
dp=1 it is the same sweep).

Left out, because they serve the TPU's compiler: the scanned and unrolled
epoch launches and ``epoch_segment``.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from qbmx_torch.core import threefry
from qbmx_torch.core.rng import RowStream, draw_seed, make_generator, rand
from qbmx_torch.models import rbm
from qbmx_torch.models.base import pad_rows, resolve_device, tree_leaves, tree_map
from qbmx_torch.models.cdqbm import init_params as cdqbm_init
from qbmx_torch.models.dqbm import (
    DQBMParams,
    clamped_fields,
    clamped_moments,
    clamped_qubo_shared,
    init_params,
    output_probs_from_samples,
    params_from_numpy,
    params_to_numpy,
    unclamped_fields,
    unclamped_moments,
    unclamped_qubo_shared,
)
from qbmx_torch.parallel.mesh import (check_device, gather_numpy, gather_tree, seed_rows,
                                      writes_files)
from qbmx_torch.samplers.api import (Sampler, get_sampler, sampler_sample_groups,
                                     with_dense_couplings)
from qbmx_torch.train.loop import _pad_batch, flatlined
from qbmx_torch.utils.metrics import History, accuracy_and_auc, get_metrics, prob_scored_auc
from qbmx_torch.utils.spans import span, spanned


# ``dqbm.params_from_numpy`` and ``params_to_numpy`` take any leading axes,
# so they carry stacked parameters (a stacked ``qbmx`` ``DQBMParams``
# fetched to the host, seed axis first) as they are; so do ``cdqbm``'s
sweep_params_from_numpy = params_from_numpy
sweep_params_to_numpy = params_to_numpy


def _sweep_generator(seeds: Sequence[int]) -> torch.Generator:
    """A sweep's own CPU generator, a pure function of its seed list."""
    state = np.random.SeedSequence(list(seeds)).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(state[0]))


def _refuse_qpu_adapters(sampler) -> None:
    """``qbmx``'s guard, with its message: a sampler that declares
    ``jit_safe = False`` (the QPU adapters, one network roundtrip a
    problem) is refused.  The native host sampler is taken."""
    if not getattr(sampler, "jit_safe", True):
        raise ValueError("seed-parallel sweeps need a jit-safe sampler")


def _seed_streams(seeds: Sequence[int], init_fn, attempt: int = 0, key=threefry.init_key):
    """Stacked initial parameters: seed s's are ``init_fn(key(s, attempt))``,
    from the key (the DQBM and CDQBM: ``qbmx``'s threefry key) or stream
    (the RBM: ``make_generator``) the single model of seed s draws them from
    (``reinit_params(attempt)``; attempt 0: its construction), so they are
    equal."""
    return tree_map(lambda *a: torch.stack(a), *(init_fn(key(s, attempt)) for s in seeds))


def _pad_to_batches(x: np.ndarray, y: np.ndarray, batch_size: int, device):
    """A ragged dataset padded to whole batches → (xb, yb, maskb, nb) on
    ``device``; the mask zeros the padded examples out of every statistic."""
    nb = -(-len(x) // batch_size)
    xp, yp, mask = _pad_batch(x, y, nb * batch_size)
    with span("sync.upload_x"):
        xb = torch.as_tensor(xp.reshape((nb, batch_size) + x.shape[1:]), device=device)
    with span("sync.upload_y"):
        yb = torch.as_tensor(yp.reshape(nb, batch_size), device=device)
    with span("sync.upload_mask"):
        maskb = torch.as_tensor(mask.reshape(nb, batch_size), device=device)
    return xb, yb, maskb, nb


def _seed_mean(tree, mask):
    """Per-seed batch average of (S, B, ...) statistics honoring the
    validity mask (B,) (``dqbm._masked_mean`` over axis 1)."""
    denom = torch.clamp(mask.sum(), min=1.0)

    def avg(leaf):
        m = mask.reshape((1, -1) + (1,) * (leaf.dim() - 2))
        return (leaf * m).sum(dim=1) / denom

    return tree_map(avg, tree)


def _clip_per_seed(tree, max_norm: float):
    """Each seed's gradient scaled so its global L2 norm is at most
    ``max_norm`` (``base.clip_by_global_norm`` per seed)."""
    gnorm = torch.sqrt(sum(torch.square(leaf).flatten(1).sum(1) for leaf in tree_leaves(tree)))
    scale = torch.clamp(torch.full_like(gnorm, max_norm) / gnorm.clamp_min(1e-12), max=1.0)
    return tree_map(lambda leaf: leaf * scale.reshape((-1,) + (1,) * (leaf.dim() - 1)), tree)


def _seed_nll(probs, y, mask):
    """(S,) mean −log p(y) over the valid examples, from (S, B, classes)
    probabilities."""
    S, B = probs.shape[:2]
    pick = torch.gather(probs, 2, y.to(torch.int64)[None, :, None].expand(S, B, 1))[..., 0]
    return (-torch.log(pick + 1e-12) * mask).sum(1) / torch.clamp(mask.sum(), min=1.0)


def _chunked(predict, x, chunk: int | None):
    """``predict`` over ``x`` (N, ...) in sampler calls of ``chunk``
    examples, each zero-padded to ``chunk``, as ``qbmx`` pads them (None:
    one call of all N): its outputs, each (S, N, ...), as numpy arrays."""
    n = x.shape[0]
    if chunk is None:
        parts = [predict(x)]
    else:
        parts = [predict(pad_rows(x[i: i + chunk], chunk)) for i in range(0, n, chunk)]
    fetched = []
    for outs in zip(*parts):
        with span("sync.val_fetch"):
            fetched.append(torch.cat(outs, dim=1)[:, :n].cpu().numpy())
    return fetched


def _snapshot_best(best, params, improved: np.ndarray):
    """Where ``improved[s]``, seed s's parameters replace its row of the
    stacked best-epoch parameters (on the device; no host copy until they
    are saved)."""
    with span("sync.best_mask"):
        imp = torch.as_tensor(improved, device=tree_leaves(params)[0].device)
    return tree_map(lambda b, p: torch.where(imp.reshape((-1,) + (1,) * (p.dim() - 1)), p, b),
                    best, params)


def _track_best(sw, histories, epoch_i: int) -> None:
    """Update ``sw.best_params`` / ``best_metric`` / ``best_epoch`` from
    this epoch's 0.5·acc + 0.5·auc of the seeds ``sw.rows`` (the
    reference's model selection); the epoch recorded counts every epoch
    trained so far."""
    rows = slice(sw.rows.start, sw.rows.stop)
    combined = np.asarray([h.combined_acc_auc_per_epoch[-1] for h in histories])
    improved = combined > sw.best_metric[rows]
    if not improved.any():
        return
    sw.best_metric[rows] = np.where(improved, combined, sw.best_metric[rows])
    sw.best_epoch[rows] = np.where(improved, sw._epochs_done + epoch_i, sw.best_epoch[rows])
    sw.best_params = _snapshot_best(sw.best_params if sw.best_params is not None else sw.params,
                                    sw.params, improved)


def _rows_of(tree, rows: range):
    return tree_map(lambda a: a[rows.start: rows.stop], tree)


def _gather_histories(mesh, histories, rows: range, S: int) -> list[History]:
    """Every seed's ``History`` on every rank, from each rank's histories of
    its ``rows`` (every series has one length across the seeds)."""
    out = [History() for _ in range(S)]
    for field in ("errors_per_batch", "error_per_epoch", "nll_per_batch", "nll_per_epoch",
                  "acc_per_epoch", "auc_per_epoch", "combined_acc_auc_per_epoch",
                  "prob_auc_per_epoch"):
        local = np.asarray([getattr(h, field) for h in histories], dtype=np.float64)
        full = gather_numpy(mesh, local.reshape(len(rows), -1), rows, S)
        for h, series in zip(out, full):
            setattr(h, field, [float(v) for v in series])
    return out


def _save_best_models(sw, folder, objs_for_seed, name_fn=None) -> dict:
    """Each seed's best-epoch weight pickle under ``folder/best_model/``,
    the reference's layout; ``objs_for_seed(one seed's parameters, on the
    host) -> pickle payload``, ``name_fn(seed, best_epoch) -> file stem``.
    Returns {seed: path} on every rank; under a mesh rank 0 alone writes."""
    if sw.best_params is None:
        raise RuntimeError("no best-epoch snapshots: train with validation data first")
    out = Path(folder) / "best_model"
    write = writes_files(sw)
    if write:
        out.mkdir(parents=True, exist_ok=True)
        host = tree_map(lambda a: a.cpu(), sw.best_params)  # fetched once for every seed
    paths = {}
    for i, seed in enumerate(sw.seeds):
        stem = (name_fn(seed, int(sw.best_epoch[i])) if name_fn is not None
                else f"_se{seed}_e{int(sw.best_epoch[i])}_best")
        path = out / f"{stem}.pkl"
        if write:
            with open(path, "wb") as f:
                pickle.dump(objs_for_seed(tree_map(lambda a: a[i], host)), f)
        paths[seed] = str(path)
    return paths


class _SeedSweep:
    """The epoch loop, flatline re-draws, best-epoch bookkeeping and seed
    sharding both sweeps share.  A subclass sets ``seeds``, ``S``,
    ``device`` and ``params``, calls :meth:`_start`, and provides
    ``_init_params(key)`` (one seed's initial parameters),
    ``_prepare(x)`` (host inputs in its layout), ``_step(x, y, mask, lr)``
    (one nll a seed it holds) and ``_validate(x, chunk)`` (numpy predictions
    and probabilities, a row a seed it holds).

    Between runs ``params`` holds every seed's rows on every rank; during a
    run, its own rows ``rows`` alone (``_held``: the seeds ``params`` holds
    now)."""

    def _start(self, mesh=None) -> None:
        if mesh is not None:
            check_device(self.device, mesh)
        self.mesh = mesh
        self.rows = seed_rows(mesh, self.S)
        self._held = range(self.S)
        # the samplers' draws: one generator for the sweep, from the seed list
        self.generator = _sweep_generator(self.seeds)
        self.best_params = None
        self.best_metric = np.full(self.S, -np.inf)
        self.best_epoch = np.zeros(self.S, dtype=int)
        # cumulative over repeated train() calls: a winner found in a later
        # call records its total epoch; re-draws continue their attempts
        self._epochs_done = 0
        self._reinit_attempts = [0] * self.S

    def _stream(self, phases: int):
        """The generator of a sampler call of ``phases`` groups a seed,
        phase-major: the sweep's own, or this rank's rows of its draws."""
        if self.mesh is None:
            return self.generator
        return RowStream(self.generator, [ph * self.S + s for ph in range(phases)
                                          for s in self.rows], phases * self.S)

    def reinit_seeds(self, indices: Sequence[int], attempt: int = 1) -> None:
        """Re-draw the listed seeds' parameters (by index) from
        ``threefry.init_key(seed, attempt)``: fresh, deterministic draws for
        flatline recovery, each equal to the single model's
        ``reinit_params(attempt)``.  Every seed listed must be held: during a
        run under a mesh, a rank re-draws its own rows only."""
        idx = torch.as_tensor([self._held.index(i) for i in indices], dtype=torch.int64,
                              device=self.device)
        fresh = _seed_streams([self.seeds[i] for i in indices], self._init_params, attempt)
        self.params = tree_map(lambda a, f: a.index_copy(0, idx, f), self.params, fresh)

    @spanned("train")
    def train(self, train_X, train_Y, val_X=None, val_Y=None, epochs: int = 1,
              batch_size: int = 8, learning_rate: float = 0.005,
              class_titles=("0", "1"), verbose: bool = True,
              reinit_on_collapse: int = 0, predict_chunk: int | None = None) -> list[History]:
        """Returns one reference-style ``History`` per seed.
        ``reinit_on_collapse`` (0 = off, needs validation data): every N
        epochs, re-draw each seed that ``train.loop.flatlined`` over them
        (never after the final epoch).  ``predict_chunk``: validation
        examples a sampler call (None: all of them in one call)."""
        xb, yb, maskb, nb = _pad_to_batches(
            self._prepare(np.asarray(train_X, dtype="float32")), np.asarray(train_Y),
            batch_size, self.device)
        xv = None
        if val_X is not None:
            xv = self._prepare(np.asarray(val_X, dtype="float32"))
            with span("sync.upload_val"):
                xv = torch.as_tensor(xv, device=self.device)
        rows = self.rows
        self.params = _rows_of(self.params, rows)
        if self.best_params is not None:
            self.best_params = _rows_of(self.best_params, rows)
        self._held = rows
        histories = [History() for _ in rows]
        for epoch_i in range(1, epochs + 1):
            with span("epoch"):
                nlls = torch.stack([self._step(xb[i], yb[i], maskb[i], learning_rate)
                                    for i in range(nb)], dim=1)  # (S, nb)
                with span("sync.epoch_nll"):
                    nlls = nlls.cpu().numpy()
                for s, h in enumerate(histories):
                    h.nll_per_batch.extend(float(v) for v in nlls[s])
                    h.nll_per_epoch.append(float(nlls[s].sum()) / nb)
                    h.errors_per_batch.extend(0.0 for _ in range(nb))
                    h.error_per_epoch.append(0.0)
                if xv is None:
                    continue
                with span("validate"):
                    preds, probs = self._validate(xv, predict_chunk)
                    for s, h in enumerate(histories):
                        acc, _, _, _, auc = get_metrics(val_Y, preds[s], list(class_titles))
                        h.acc_per_epoch.append(acc)
                        h.auc_per_epoch.append(auc)
                        h.combined_acc_auc_per_epoch.append(0.5 * acc + 0.5 * auc)
                        h.prob_auc_per_epoch.append(prob_scored_auc(val_Y, probs[s]))
                _track_best(self, histories, epoch_i)
                if verbose:
                    accs = [h.acc_per_epoch[-1] for h in histories]
                    print(f"Epoch {epoch_i}/{epochs}  val_acc mean {np.mean(accs):.4f} "
                          f"[{np.min(accs):.4f}, {np.max(accs):.4f}]")
                if (reinit_on_collapse and epoch_i % reinit_on_collapse == 0
                        and epoch_i < epochs):
                    collapsed = [s for s, h in zip(rows, histories)
                                 if flatlined(h.acc_per_epoch, val_Y, reinit_on_collapse)]
                    for s in collapsed:
                        self._reinit_attempts[s] += 1
                        self.reinit_seeds([s], attempt=self._reinit_attempts[s])
                    if collapsed and verbose:
                        print("re-initialized flatlined seeds "
                              f"{[self.seeds[s] for s in collapsed]}")
        self._epochs_done += epochs
        self._held = range(self.S)
        if self.mesh is None:
            return histories
        self.params = gather_tree(self.mesh, self.params, rows, self.S)
        if self.best_params is not None:
            self.best_params = gather_tree(self.mesh, self.best_params, rows, self.S)
        gather = lambda a: gather_numpy(
            self.mesh, np.asarray(a[rows.start: rows.stop], np.float64), rows, self.S)
        self.best_metric = gather(self.best_metric)
        self.best_epoch = gather(self.best_epoch).astype(int)
        self._reinit_attempts = [int(a) for a in gather(self._reinit_attempts)]
        return _gather_histories(self.mesh, histories, rows, self.S)

    def params_for_seed(self, s: int):
        """Seed ``s``'s parameters (by index) out of the stacked ones."""
        return tree_map(lambda a: a[s], self.params)

    def best_params_for_seed(self, s: int):
        """Seed ``s``'s parameters at its best combined-acc/AUC epoch."""
        if self.best_params is None:
            raise RuntimeError("no validation epochs recorded yet")
        return tree_map(lambda a: a[s], self.best_params)


class SeedParallelDQBM(_SeedSweep):
    """Train S flat Disc_QBMs (one per seed) as a single batched program.

    Hyperparameters mirror :class:`qbmx_torch.models.dqbm.DiscQBM`;
    ``predict_sample_count`` sets the validation reads (default
    ``sample_count``).  ``device`` defaults to the card, as the models'.
    ``mesh``: shard the seeds over its dp axis (module docstring); the
    sweep lives on the mesh's device."""

    def __init__(
        self,
        seeds: Sequence[int],
        dim_input: int,
        num_classes: int = 2,
        n_hidden_nodes: int = 4,
        restricted: bool = False,
        sample_count: int = 20,
        anneal_steps: int = 20,
        beta_eff: float = 1.0,
        use_one_hot_encoding: bool = False,
        solver: str = "SA",
        sampler: Sampler | None = None,
        grad_clip: float = 0.0,
        predict_sample_count: int | None = None,
        device="cuda",
        mesh=None,
    ):
        self.seeds = [int(s) for s in seeds]
        self.S = len(self.seeds)
        self.dim_input = dim_input
        self.n_hidden_nodes = n_hidden_nodes
        self.n_output_nodes = num_classes if use_one_hot_encoding else 1
        self.use_one_hot_encoding = use_one_hot_encoding
        self.restricted = restricted
        self.sample_count = sample_count
        self.predict_sample_count = (sample_count if predict_sample_count is None
                                     else int(predict_sample_count))
        self.beta_eff = float(beta_eff)
        self.grad_clip = float(grad_clip)
        self.device = resolve_device(device)
        self.sampler = sampler if sampler is not None else with_dense_couplings(
            get_sampler(solver, num_sweeps=anneal_steps), not restricted)
        _refuse_qpu_adapters(self.sampler)
        self._start(mesh)
        self.params = _seed_streams(self.seeds, self._init_params)

    def _init_params(self, key: np.ndarray) -> DQBMParams:
        return init_params(key, self.dim_input, self.n_hidden_nodes, self.n_output_nodes,
                           self.restricted, self.device)

    def _prepare(self, x: np.ndarray) -> np.ndarray:
        return x

    # -- batched computations ------------------------------------------------

    def _y_vec(self, y):
        if self.use_one_hot_encoding:
            return torch.nn.functional.one_hot(y.to(torch.int64), self.n_output_nodes) \
                .to(torch.float32)
        return y.to(torch.float32)[:, None]

    def _probs(self, s_u):
        """(S, B, R, O+H) unclamped samples → (S, B, classes) probabilities."""
        probs = output_probs_from_samples(s_u.flatten(0, 1), self.n_output_nodes,
                                          self.use_one_hot_encoding)
        return probs.unflatten(0, s_u.shape[:2])

    def step_qubos(self, x, y):
        """The step's one sampler call on inputs ``x`` (B, D) and labels
        ``y`` (B,): ``(Q_all (2·S, n_u, n_u), h_all (2·S, B, n_u))``, every
        seed's clamped group first, then every seed's unclamped group; the
        clamped groups are zero-padded to n_u (the padding couples to
        nothing and is sliced off)."""
        p, S, beta = self.params, len(self._held), self.beta_eff
        y_vec = self._y_vec(y)
        B, H = x.shape[0], self.n_hidden_nodes
        Qu = unclamped_qubo_shared(p, beta)  # (S, n_u, n_u)
        n_u = Qu.shape[-1]
        Q_all = Qu.new_zeros((2 * S, n_u, n_u))
        Q_all[:S, :H, :H] = clamped_qubo_shared(p, beta)
        Q_all[S:] = Qu
        h_all = Qu.new_zeros((2 * S, B, n_u))
        h_all[:S, :, :H] = clamped_fields(p, x, y_vec, beta)
        h_all[S:] = unclamped_fields(p, x, beta)
        return Q_all, h_all

    @spanned("step")
    @torch.no_grad()
    def _step(self, x, y, mask, lr):
        """One update of every seed's parameters from ONE sampler call;
        returns the (S,) nlls on the device."""
        p = self.params
        S, O = len(self._held), self.n_output_nodes
        y_vec = self._y_vec(y)
        B, H = x.shape[0], self.n_hidden_nodes
        Q_all, h_all = self.step_qubos(x, y)
        s_all = sampler_sample_groups(self.sampler, self._stream(2), Q_all, h_all,
                                      self.sample_count)  # (2S, B, R, n_u)
        s_c, s_u = s_all[:S, :, :, :H], s_all[S:]

        # the single model's moments over seeds × examples, then per seed
        xs = x.expand(S, *x.shape).flatten(0, 1)
        ys = y_vec.expand(S, *y_vec.shape).flatten(0, 1)
        mc = clamped_moments(s_c.flatten(0, 1), xs, ys)
        mu = unclamped_moments(s_u.flatten(0, 1), xs, O)
        grad = _seed_mean(tree_map(lambda a, b: (a - b).unflatten(0, (S, B)), mc, mu), mask)
        if self.restricted:
            grad.w_hh = torch.zeros_like(grad.w_hh)
        if self.grad_clip > 0.0:
            grad = _clip_per_seed(grad, self.grad_clip)
        self.params = tree_map(lambda a, g: a - lr * g, p, grad)

        return _seed_nll(self._probs(s_u), y, mask)

    @torch.no_grad()
    def _predict(self, x):
        """ONE sampler call over S groups of the inputs → (S, N, O) output
        marginals and (S, N, classes) probabilities."""
        p = self.params
        s_u = sampler_sample_groups(self.sampler, self._stream(1),
                                    unclamped_qubo_shared(p, self.beta_eff),
                                    unclamped_fields(p, x, self.beta_eff),
                                    self.predict_sample_count)  # (S, N, R, n_u)
        return s_u[..., :self.n_output_nodes].mean(dim=2), self._probs(s_u)

    @spanned("predict")
    def _validate(self, x, chunk):
        marg, probs = _chunked(self._predict, x, chunk)
        preds = (np.argmax(marg, axis=2) if self.use_one_hot_encoding
                 else np.round(marg[..., 0]).astype(int))
        return preds, probs

    def save_best_models(self, folder, name_fn=None) -> dict:
        """Per-seed best-epoch weight pickles under ``folder/best_model/``
        in the reference 5/6-tuple format ``DiscQBM.load_savepoint`` reads
        in both packages."""

        def objs(p):
            d = params_to_numpy(p)
            return [d[k] for k in ("w_vh", "w_vo", "b_h", "b_o", "w_oo")] \
                + ([] if self.restricted else [d["w_hh"]])

        return _save_best_models(self, folder, objs, name_fn)


class SeedParallelCDQBM(_SeedSweep):
    """Train S convolutional deep QBMs (one per seed) as a single batched
    program.

    A donor :class:`qbmx_torch.models.cdqbm.CDQBM` supplies the geometry,
    flags, sampler, device and the builders, which take the stacked
    parameters; its own parameters and generator are not used.  Seed s's
    parameters come from ``threefry.init_key(s, attempt)`` through
    ``cdqbm.init_params``, equal to ``CDQBM(seed=s)``'s and ``qbmx``'s.  A step is one
    sampler call of 2·S groups of B problems, the clamped groups
    zero-padded from n_hidden to n_total (``CDQBM.step_qubos``); a
    validation chunk of ``train(predict_chunk=32)`` examples one call of S
    groups.  ``params_from_numpy`` / ``params_to_numpy`` of
    ``models/cdqbm.py`` carry the stacked parameters to and from numpy
    (a stacked ``qbmx`` ``CDQBMParams``, seed axis first).  ``mesh``:
    shard the seeds over its dp axis (module docstring); the donor lives
    on the mesh's device."""

    def __init__(self, seeds: Sequence[int], model, mesh=None):
        _refuse_qpu_adapters(model.sampler)
        self.model = model
        self.seeds = [int(s) for s in seeds]
        self.S = len(self.seeds)
        self.device = model.device
        self._start(mesh)
        self.params = _seed_streams(self.seeds, self._init_params)

    def train(self, *args, predict_chunk: int = 32, **kwargs) -> list[History]:
        """:meth:`_SeedSweep.train`, validating ``predict_chunk`` examples a
        sampler call (each chunk zero-padded, as ``qbmx`` pads it)."""
        return super().train(*args, predict_chunk=predict_chunk, **kwargs)

    def _init_params(self, key: np.ndarray):
        m = self.model
        return cdqbm_init(key, m.geo, m.hidden_bias_type, m.is_restricted,
                          m.learn_penalty, m.prob_penalty, m.device)

    def _prepare(self, x: np.ndarray) -> np.ndarray:
        return self.model._prepare_inputs(x)

    def step_qubos(self, x, y):
        """The step's one sampler call on images ``x`` (B, H, W) and labels
        ``y`` (B,): ``(Q_all (2·S, n_total, n_total), h_all (2·S, B,
        n_total))``."""
        return self.model.step_qubos(self.params, x, self.model._label_vec(y))

    @spanned("step")
    @torch.no_grad()
    def _step(self, x, y, mask, lr):
        """One update of every seed's parameters from ONE sampler call;
        returns the (S,) nlls on the device."""
        m, p, S = self.model, self.params, len(self._held)
        y_vec = m._label_vec(y)
        ctx = m._context(p, x)
        Q_all, h_all = m.step_qubos(p, x, y_vec, ctx)
        s_all = sampler_sample_groups(m.sampler, self._stream(2), Q_all, h_all,
                                      m.sample_count)  # (2S, B, R, n_total)
        s_c, s_u = s_all[:S, :, :, :m.geo.n_hidden], s_all[S:]
        mc = m._moments(p, s_c, ctx, y_vec)
        mu = m._moments(p, s_u, ctx)
        grad = _seed_mean(tree_map(lambda a, b: a - b, mc, mu), mask)
        if m.is_restricted:
            grad.w_seq_intra = tuple(torch.zeros_like(w) for w in grad.w_seq_intra)
        if m.hidden_bias_type == "none":
            grad.b_conv = torch.zeros_like(grad.b_conv)
        if m.grad_clip > 0.0:
            grad = _clip_per_seed(grad, m.grad_clip)
        self.params = tree_map(lambda a, g: a - lr * g, p, grad)
        return _seed_nll(m._probs_from_samples(s_u), y, mask)

    @torch.no_grad()
    def _predict(self, x):
        """ONE sampler call over S groups of the images → ((S, N, classes)
        probabilities,)."""
        m, p = self.model, self.params
        s_u = sampler_sample_groups(m.sampler, self._stream(1), m.unclamped_qubo_shared(p),
                                    m.unclamped_fields(p, x), m.sample_count)
        return (m._probs_from_samples(s_u),)

    @spanned("predict")
    def _validate(self, x, chunk):
        (probs,) = _chunked(self._predict, x, chunk)
        return np.argmax(probs, axis=2), probs

    def save_best_models(self, folder, name_fn=None) -> dict:
        """Per-seed best-epoch weight pickles under ``folder/best_model/``
        in the reference 8/9-entry format ``CDQBM.load_params`` reads in
        both packages."""
        return _save_best_models(self, folder,
                                 lambda p: self.model.weight_objects(params=p), name_fn)


class SeedParallelRBM:
    """Train S ``ClassificationRBM``s (one per seed) as one batched program.

    The parameters are stacked over a leading seed axis ((S, V, H)
    weights); every product is a batched matmul over it, and the gradient
    of the sum over seeds of each seed's mean nll is each seed's own
    gradient.  Seed s's initial parameters are ``ClassificationRBM(seed=s)``'s
    (``make_generator(s, 0)``).  Each epoch draws one seed off the sweep's
    CPU generator (a pure function of the seed list) to key a generator on
    the device for every seed's shuffle and CD draws.  Kept from ``qbmx``:
    the ragged tail batch is dropped, ``pcd`` and a set smaller than a
    batch are refused, the test probabilities are computed every epoch on
    the device and fetched once at the end, and the best epoch is chosen
    by 0.5·acc + 0.5·AUC, counted across ``sweep()`` calls.  ``mesh``:
    shard the seeds over its dp axis (module docstring); a rank's shuffles
    and chain draws are its rows of the whole sweep's, so the sharded sweep
    is the unsharded one bit for bit."""

    def __init__(self, seeds: Sequence[int], num_visible: int, num_hidden: int,
                 num_classes: int = 2, k: int = 1, learning_rate: float = 0.05,
                 method: str = "discriminative", sparse_constant: float = 0.0,
                 generative_factor: float = 0.0, device="cuda", mesh=None):
        if method == "pcd":
            raise ValueError("pcd carries host-side chain state; use "
                             "ClassificationRBM per seed")
        self.seeds = [int(s) for s in seeds]
        self.S = len(self.seeds)
        self.num_classes = num_classes
        self.learning_rate = float(learning_rate)
        self.device = resolve_device(device)
        if mesh is not None:
            check_device(self.device, mesh)
        self.mesh = mesh
        self.rows = seed_rows(mesh, self.S)
        self.params = _seed_streams(self.seeds, lambda g: rbm.init_params(
            g, num_visible, num_hidden, num_classes, self.device), key=make_generator)
        self._epoch = rbm.make_epoch_scan(rbm.make_train_step(
            num_classes, method=method, cd_k=k, sparse_constant=sparse_constant,
            generative_factor=generative_factor, stacked=True))
        self.generator = _sweep_generator(self.seeds)
        self.best_params = None
        self.best_metric = np.full(self.S, -np.inf)
        self.best_epoch = np.zeros(self.S, dtype=int)
        # cumulative over repeated sweep() calls: a winner found in a later
        # call records its total epoch
        self._epochs_done = 0

    def sweep(self, train_x, train_y, test_x, test_y, epochs: int, batch_size: int,
              shuffle: bool = True):
        """Returns (acc_lists, auc_lists): per seed, per epoch (the
        reference ``rbm_main`` pickles)."""
        dev, S, rows = self.device, len(self.rows), self.rows
        x = torch.as_tensor(rbm._host_rows(train_x), device=dev)
        tx = torch.as_tensor(rbm._host_rows(test_x), device=dev)
        y = torch.as_tensor(np.asarray(train_y), device=dev)
        n = x.shape[0]
        nb = n // batch_size
        if nb == 0:
            raise ValueError(
                f"batch_size={batch_size} exceeds the {n}-example training "
                "set: the sweep would train nothing (the per-seed "
                "ClassificationRBM path trains the remainder batch instead)")
        m = nb * batch_size
        probs, per_epoch = [], []
        params = _rows_of(self.params, rows)  # this rank's seeds (all without a mesh)
        for _ in range(epochs):
            gen = torch.Generator(device=dev).manual_seed(draw_seed(self.generator))
            stream = gen if self.mesh is None else RowStream(gen, rows, self.S)
            order = (torch.argsort(rand((S, n), stream, dev), dim=1)
                     if shuffle else torch.arange(n, device=dev).expand(S, n))[:, :m]
            xb = x[order].reshape(S, nb, batch_size, -1).transpose(0, 1)  # (nb, S, bs, V)
            yb = y[order].reshape(S, nb, batch_size).transpose(0, 1)
            params, _ = self._epoch(params, stream, xb, yb, self.learning_rate)
            with torch.no_grad():
                probs.append(rbm.predict_proba(params, tx, stacked=True))  # (S, n_test, C)
            per_epoch.append(params)
        probs = torch.stack(probs).cpu().numpy()  # ONE fetch for the whole sweep
        ty = np.asarray(test_y)
        acc_lists = [[] for _ in range(S)]
        auc_lists = [[] for _ in range(S)]
        for e in range(epochs):
            for s in range(S):
                acc, auc = accuracy_and_auc(ty, np.argmax(probs[e, s], axis=-1))
                acc_lists[s].append(acc)
                auc_lists[s].append(auc)
        # best epoch per seed (0.5·acc + 0.5·auc, the reference's selection);
        # repeated sweep() calls keep the global winner
        combined = 0.5 * np.asarray(acc_lists) + 0.5 * np.asarray(auc_lists)
        best_e = np.argmax(combined, axis=1)
        best_val = combined[np.arange(S), best_e]
        own = slice(rows.start, rows.stop)
        improved = best_val > self.best_metric[own]
        pick = (torch.as_tensor(best_e, device=dev), torch.arange(S, device=dev))
        run_best = tree_map(lambda *a: torch.stack(a)[pick], *per_epoch)
        self.best_params = _snapshot_best(
            run_best if self.best_params is None else _rows_of(self.best_params, rows),
            run_best, improved)
        best_metric = np.where(improved, best_val, self.best_metric[own])
        best_epoch = np.where(improved, self._epochs_done + best_e + 1, self.best_epoch[own])
        self._epochs_done += epochs
        self.params = params
        if self.mesh is None:
            self.best_metric, self.best_epoch = best_metric, best_epoch
            return acc_lists, auc_lists
        # every seed's rows on every rank
        self.params = gather_tree(self.mesh, params, rows, self.S)
        self.best_params = gather_tree(self.mesh, self.best_params, rows, self.S)
        self.best_metric = gather_numpy(self.mesh, best_metric, rows, self.S)
        self.best_epoch = gather_numpy(self.mesh, best_epoch.astype(np.int64), rows, self.S)
        acc_full = gather_numpy(self.mesh, np.asarray(acc_lists, np.float64), rows, self.S)
        auc_full = gather_numpy(self.mesh, np.asarray(auc_lists, np.float64), rows, self.S)
        return ([[float(a) for a in r] for r in acc_full],
                [[float(a) for a in r] for r in auc_full])

    def params_for_seed(self, s: int):
        """Seed ``s``'s parameters (by index) out of the stacked ones."""
        return tree_map(lambda a: a[s], self.params)

    def best_params_for_seed(self, s: int):
        """Seed ``s``'s parameters at its best combined-acc/AUC epoch."""
        if self.best_params is None:
            raise RuntimeError("call sweep() first")
        return tree_map(lambda a: a[s], self.best_params)

    def save_best_models(self, folder, name_fn=None) -> dict:
        """Per-seed best-epoch weight pickles under ``folder/best_model/``
        in the 5-list format ``ClassificationRBM.load_params`` reads in both
        packages."""
        return _save_best_models(
            self, folder, lambda p: list(rbm.params_to_numpy(p).values()), name_fn)
