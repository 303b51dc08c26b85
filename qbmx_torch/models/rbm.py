"""Discriminative RBM in PyTorch — counterpart of ``qbmx.models.rbm``.

A Larochelle-style discriminative RBM over (visible, hidden, class) units:

  * the **exact** discriminative gradient: ``torch.autograd`` of the
    closed-form ``-log p(y|x)`` (``discriminative_nll``), as ``qbmx`` takes
    ``jax.value_and_grad`` of it;
  * a **CD-k / PCD generative** path and a hybrid of the two, with the
    mean-field final CD update (``cd_stats``).

Every function takes parameters with an optional leading seed axis: (S,
V, H) weights give (S, ...) results from batched matmuls, which is how
``train/sweep.SeedParallelRBM`` trains S models at once.

``compute_dtype=torch.bfloat16`` follows JAX's type promotion, which torch
does not do on its own: a bf16 state times an f32 weight is an f32 product
(the state is cast up), and the two statistics products are bf16 × bf16
with a bf16 result, cast to f32 afterwards.  Parameters and updates stay
f32; in f32 every product is a full-precision f32 product (TF32 is never
turned on).

Random numbers come from an explicit ``torch.Generator`` through
:class:`Draws`: ``bernoulli(p)`` is ``uniform < p`` and ``categorical``
is the argmax of the logits plus Gumbel noise, both in float32, which is
what ``jax.random`` computes; a test passes ``qbmx``'s own variates in
their place.  ``ClassificationRBM`` keys one generator on its device per
epoch from a seed drawn off its CPU generator, so a checkpoint carries
only that generator's state and a resumed run is bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from qbmx_torch.core.rng import draw_seed, make_generator, rand
from qbmx_torch.models.base import (
    load_weight_pickle,
    resolve_device,
    save_weight_pickle,
    tree_leaves,
    tree_map,
)

METHODS = ("discriminative", "generative", "pcd", "hybrid")


@dataclasses.dataclass
class RBMParams:
    weights: torch.Tensor  # (V, H)
    visible_bias: torch.Tensor  # (V,)
    hidden_bias: torch.Tensor  # (H,)
    class_bias: torch.Tensor  # (C,)
    class_weights: torch.Tensor  # (C, H)


FIELDS = tuple(f.name for f in dataclasses.fields(RBMParams))


def params_from_numpy(d, device="cpu") -> RBMParams:
    """``RBMParams`` on ``device`` from a mapping of the five fields to
    numpy arrays (e.g. the fields of a ``qbmx`` ``RBMParams``, stacked over
    seeds or not)."""
    return RBMParams(**{k: torch.tensor(np.asarray(d[k], dtype=np.float32), device=device)
                        for k in FIELDS})


def params_to_numpy(p: RBMParams) -> dict:
    """The five fields as float32 numpy arrays."""
    return {k: getattr(p, k).detach().cpu().numpy() for k in FIELDS}


def init_params(generator: torch.Generator, num_visible: int, num_hidden: int,
                num_classes: int, device="cpu") -> RBMParams:
    """Reference init (``src/ClassificationRBM.py:26-30``): weights ~
    0.1·N(0,1) (drawn on the generator's device); visible bias 0.5;
    hidden/class biases and class weights 0."""
    w = torch.randn((num_visible, num_hidden), generator=generator, device=generator.device)
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)
    return RBMParams(
        weights=(0.1 * w).to(device),
        visible_bias=torch.full((num_visible,), 0.5, device=device),
        hidden_bias=zeros(num_hidden),
        class_bias=zeros(num_classes),
        class_weights=zeros(num_classes, num_hidden),
    )


# ---------------------------------------------------------------------------
# Exact discriminative path
# ---------------------------------------------------------------------------


def _seedwise(fn, t: torch.Tensor, stacked: bool) -> torch.Tensor:
    """``fn(t)`` for an elementwise ``fn``; seed by seed for a tensor
    stacked over seeds on the CPU.  The CPU's vectorized kernels compute a
    tensor's last elements in scalar code, which rounds softplus and
    sigmoid differently, so a seed's values would otherwise depend on how
    many seeds share the tensor (a seed-sharded sweep reproduces the
    unsharded one bit for bit).  On the card every element takes one code.
    ``stacked``: ``t``'s leading axis is the seeds' (the sweep says so)."""
    if not stacked or t.device.type != "cpu":
        return fn(t)
    return torch.stack([fn(seed) for seed in t.unbind(0)])


def class_logits(params: RBMParams, x: torch.Tensor, stacked: bool = False) -> torch.Tensor:
    """log p(y|x) + const: (..., B, C); ``stacked``: the parameters have a
    leading seed axis.

    ``logit_y = d_y + Σ_j softplus(c_j + x·W_j + U_yj)`` (torch's softplus
    goes linear past 20, where ``jax.nn.softplus`` is ``logaddexp(x, 0)``:
    at most 2e-9 apart in float32)."""
    W = params.weights
    pre = x.to(W.dtype) @ W + params.hidden_bias[..., None, :]  # (..., B, H)
    act = pre[..., :, None, :] + params.class_weights[..., None, :, :]  # (..., B, C, H)
    return params.class_bias[..., None, :] + _seedwise(F.softplus, act, stacked).sum(dim=-1)


def predict_proba(params: RBMParams, x: torch.Tensor, stacked: bool = False) -> torch.Tensor:
    return torch.softmax(class_logits(params, x, stacked), dim=-1)


def discriminative_nll(params: RBMParams, x: torch.Tensor, y: torch.Tensor,
                       stacked: bool = False) -> torch.Tensor:
    """Mean −log p(y|x) over the batch axis: a scalar, or (S,) for
    parameters stacked over seeds."""
    logp = torch.log_softmax(class_logits(params, x, stacked), dim=-1)
    return -torch.gather(logp, -1, y.to(torch.int64)[..., None])[..., 0].mean(dim=-1)


def nll_and_grad(params: RBMParams, x, y, stacked: bool = False):
    """(nll, its gradient as ``RBMParams``) by autograd of the sum over
    seeds of each seed's mean nll, which is each seed's own gradient; the
    visible bias does not enter p(y|x) and gets a zero gradient."""
    with torch.enable_grad():
        leaves = tree_map(lambda a: a.detach().requires_grad_(True), params)
        nll = discriminative_nll(leaves, x, y, stacked)
        flat = tree_leaves(leaves)
        grads = torch.autograd.grad(nll.sum(), flat, allow_unused=True)
    grads = [torch.zeros_like(a) if g is None else g for a, g in zip(flat, grads)]
    return nll.detach(), RBMParams(*grads)


# ---------------------------------------------------------------------------
# Generative CD-k path
# ---------------------------------------------------------------------------


class Draws:
    """The random numbers of a CD chain, in the order the chain uses them:
    drawn from ``generator`` on its device, or, where ``variates`` is
    given, taken from it one array a draw (host-supplied: for each full
    Gibbs step the hidden uniforms, the visible uniforms and the class
    Gumbel noise, then the final hidden uniforms).  ``stacked``: the
    draws have a leading seed axis."""

    def __init__(self, generator: torch.Generator | None = None, variates=None,
                 stacked: bool = False):
        self.generator = generator
        self.stacked = stacked
        self._host = iter(variates) if variates is not None else None

    def _take(self, shape, device) -> torch.Tensor:
        v = torch.tensor(np.asarray(next(self._host), dtype=np.float32), device=device)
        if tuple(v.shape) != tuple(shape):
            raise ValueError(f"host variate of shape {tuple(v.shape)}, expected {tuple(shape)}")
        return v

    def uniform(self, shape, device) -> torch.Tensor:
        if self._host is not None:
            return self._take(shape, device)
        return rand(shape, self.generator, device)

    def gumbel(self, shape, device) -> torch.Tensor:
        """``jax.random.gumbel``: −log(−log(u)), u uniform on [tiny, 1)."""
        if self._host is not None:
            return self._take(shape, device)
        u = rand(shape, self.generator, device).clamp_min_(torch.finfo(torch.float32).tiny)
        return _seedwise(lambda t: -torch.log(-torch.log(t)), u, self.stacked)


def _bernoulli(draws: Draws, p: torch.Tensor) -> torch.Tensor:
    return draws.uniform(p.shape, p.device) < p


def _categorical(draws: Draws, logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits + draws.gumbel(logits.shape, logits.device), dim=-1)


def _hidden_prob(params, v, y_onehot, stacked: bool = False):
    W, U = params.weights, params.class_weights
    z = v.to(W.dtype) @ W + params.hidden_bias[..., None, :] + y_onehot.to(U.dtype) @ U
    return _seedwise(torch.sigmoid, z, stacked)


def _visible_prob(params, h, stacked: bool = False):
    W = params.weights
    return _seedwise(torch.sigmoid, h.to(W.dtype) @ W.mT + params.visible_bias[..., None, :],
                     stacked)


def _class_prob(params, h):
    U = params.class_weights
    return torch.softmax(h.to(U.dtype) @ U.mT + params.class_bias[..., None, :], dim=-1)


def cd_stats(params: RBMParams, v0, y_onehot, k: int, v_init=None, y_init=None,
             compute_dtype=torch.float32, persistent: bool = False,
             draws: Draws | None = None, stacked: bool = False):
    """CD-k positive/negative statistics (``qbmx.models.rbm.cd_stats``).

    Returns ``(pos, neg, (vk, yk), recon)``: batch-meaned expected
    sufficient statistics as float32 ``RBMParams``, the final chain state
    (for PCD) and the visible reconstruction of the last step.  Binary
    hidden samples drive the chain; intermediate steps sample everything;
    the final update is mean-field (reconstructions enter the negative
    statistics as probabilities).  ``persistent=True`` keeps the fully
    sampled chain, whose binary fantasy particles carry across steps.
    ``stacked``: the parameters have a leading seed axis."""
    dt = compute_dtype
    draws = draws if draws is not None else Draws()
    B = v0.shape[-2]
    v0 = v0.to(dt)
    y_onehot = y_onehot.to(dt)
    hidden = lambda v, y: _hidden_prob(params, v, y, stacked)
    visible = lambda h: _visible_prob(params, h, stacked)
    ph0 = hidden(v0, y_onehot).to(dt)
    v, y = (v0, y_onehot) if v_init is None else (v_init.to(dt), y_init.to(dt))

    def gibbs(v, y):
        h = _bernoulli(draws, hidden(v, y)).to(dt)
        pv = visible(h)
        v = _bernoulli(draws, pv).to(dt)
        py = _class_prob(params, h)
        logits = _seedwise(torch.log, py + 1e-12, stacked)
        y = F.one_hot(_categorical(draws, logits), py.shape[-1]).to(dt)
        return v, y

    def stats(v, y, ph):
        return RBMParams(
            weights=(v.mT @ ph / B).float(),
            visible_bias=v.mean(dim=-2).float(),
            hidden_bias=ph.mean(dim=-2).float(),
            class_bias=y.mean(dim=-2).float(),
            class_weights=(y.mT @ ph / B).float(),
        )

    pos = stats(v0, y_onehot, ph0)

    if persistent:
        for _ in range(k):
            v, y = gibbs(v, y)
        phk = hidden(v, y).to(dt)
        recon = visible(phk).to(dt)
        return pos, stats(v, y, phk), (v, y), recon

    for _ in range(k - 1):  # intermediate steps fully sampled
        v, y = gibbs(v, y)
    # final mean-field update
    h = _bernoulli(draws, hidden(v, y)).to(dt)
    pv = visible(h).to(dt)
    py = _class_prob(params, h).to(dt)
    phk = hidden(pv, py).to(dt)
    return pos, stats(pv, py, phk), (pv, py), pv


# ---------------------------------------------------------------------------
# Training steps
# ---------------------------------------------------------------------------


def make_train_step(num_classes: int, method: str = "discriminative", cd_k: int = 1,
                    sparse_constant: float = 0.0, generative_factor: float = 0.0,
                    compute_dtype=torch.float32, stacked: bool = False):
    """Build a step ``(params, x, y, lr, chain=None, generator=None,
    variates=None) -> (params, loss[, chain])``.

    method: 'discriminative' (exact gradient), 'generative' (CD-k), 'pcd'
    (the Gibbs chain carries over between steps) or 'hybrid' (disc +
    generative_factor · CD-k).  ``generator`` / ``variates`` feed the CD
    chain's draws (:class:`Draws`).  The loss is a device tensor (one a
    seed for parameters ``stacked`` over a leading seed axis)."""
    if method not in METHODS:
        # an unknown string would otherwise silently no-op (zero updates,
        # constant-0 loss): the run "succeeds" with an untrained model
        raise ValueError(
            f"unknown method {method!r}: expected 'discriminative', "
            "'generative', 'pcd', or 'hybrid'")
    persistent = method == "pcd"

    @torch.no_grad()
    def step(params: RBMParams, x, y, lr, chain=None, generator=None, variates=None):
        updates = tree_map(torch.zeros_like, params)
        loss = x.new_zeros((), dtype=torch.float32)
        new_chain = chain
        if method in ("discriminative", "hybrid"):
            nll, grad = nll_and_grad(params, x, y, stacked)
            updates = tree_map(lambda u, g: u - g, updates, grad)
            loss = nll
        if method in ("generative", "hybrid", "pcd"):
            factor = generative_factor if method == "hybrid" else 1.0
            y_onehot = F.one_hot(y.to(torch.int64), num_classes).to(torch.float32)
            v_init, y_init = chain if persistent and chain is not None else (None, None)
            pos, neg, new_chain, recon = cd_stats(
                params, x, y_onehot, cd_k, v_init=v_init, y_init=y_init,
                compute_dtype=compute_dtype, persistent=persistent,
                draws=Draws(generator, variates, stacked), stacked=stacked)
            updates = tree_map(lambda u, p, n: u + factor * (p - n), updates, pos, neg)
            if method == "generative":
                # reconstruction error from the CD chain itself
                loss = ((x.to(recon.dtype) - recon) ** 2).mean(dim=(-2, -1)).float()
            elif method == "pcd":
                # fantasy-particle recon says nothing about x: the data
                # mean-field reconstruction error instead
                ph = _hidden_prob(params, x, y_onehot, stacked)
                loss = ((x - _visible_prob(params, ph, stacked)) ** 2).mean(dim=(-2, -1))
        new = tree_map(lambda p, u: p + lr * u, params, updates)
        # sparsity shrinkage on biases, reference ``update_weights``
        # (``src/ClassificationRBM.py:96-99``)
        if sparse_constant:
            new = dataclasses.replace(
                new,
                visible_bias=new.visible_bias - sparse_constant,
                hidden_bias=new.hidden_bias - sparse_constant,
                class_bias=new.class_bias - sparse_constant,
            )
        if persistent:
            return new, loss, new_chain
        return new, loss

    return step


def make_epoch_scan(step_fn):
    """Whole-epoch loop over pre-batched (N_b, ..., B, V) / (N_b, ..., B)
    tensors: a loop of steps on one generator; returns (params, the mean
    loss as a device tensor)."""

    def epoch(params: RBMParams, generator, xb, yb, lr):
        losses = []
        for x, y in zip(xb, yb):
            params, loss = step_fn(params, x, y, lr, generator=generator)
            losses.append(loss)
        return params, torch.stack(losses).mean(dim=0)

    return epoch


def _host_rows(x) -> np.ndarray:
    """Host inputs as float32 rows (image-shaped input flattened)."""
    x = np.asarray(x, dtype=np.float32)
    return x.reshape(len(x), -1)


# ---------------------------------------------------------------------------
# Stateful wrapper (reference API surface)
# ---------------------------------------------------------------------------


class ClassificationRBM:
    """Stateful RBM with the reference's API (``train_rbm`` / ``predict`` /
    ``run_test_set``).

    Randomness comes from one CPU ``torch.Generator``, a pure function of
    ``(seed, attempt)``: it draws the initial weights and, each epoch, the
    seed of a generator on the model's device for that epoch's shuffle and
    CD draws.  ``compute_dtype`` sets the CD statistics' dtype
    (:func:`cd_stats`; ``torch.bfloat16`` is the throughput mode)."""

    def __init__(self, num_visible: int, num_hidden: int, k: int = 1, num_classes: int = 2,
                 learning_rate: float = 0.05, sparse_constant: float = 0.0, seed: int = 42,
                 method: str = "discriminative", generative_factor: float = 0.0,
                 compute_dtype=torch.float32, device="cuda"):
        self.num_visible = num_visible
        self.num_hidden = num_hidden
        self.k = k
        self.num_classes = num_classes
        self.learning_rate = learning_rate
        self.seed = seed
        self.method = method
        self.device = resolve_device(device)
        self._step = make_train_step(
            num_classes, method=method, cd_k=k, sparse_constant=sparse_constant,
            generative_factor=generative_factor, compute_dtype=compute_dtype)
        self._epoch = make_epoch_scan(self._step)
        self.reinit_params(attempt=0)
        self.acc_per_epoch_list: list[float] = []
        self.auc_per_epoch_list: list[float] = []
        # cumulative per-epoch nll, so a checkpoint written after a resume
        # carries the full history aligned with acc/auc
        self.nll_per_epoch_list: list[float] = []
        # flatline-recovery counter; checkpointed, so a resumed run goes on
        # at the next attempt
        self._reinit_attempt = 0

    def reinit_params(self, attempt: int = 1) -> None:
        """Re-draw the parameters and the random stream from a generator
        that is a pure function of ``(seed, attempt)`` (attempt 0: the
        initial draw).  Resets any PCD chain."""
        self.generator = make_generator(self.seed, attempt)
        self.params = init_params(self.generator, self.num_visible, self.num_hidden,
                                  self.num_classes, self.device)
        self._chain = None

    def _epoch_generator(self) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(draw_seed(self.generator))

    def train_rbm(self, train_x, train_y, epochs, batch_size, test_x=None, test_y=None,
                  shuffle=True, reinit_on_collapse: int = 0, checkpoint_every: int = 0,
                  checkpoint_path=None, start_epoch: int = 0):
        """Epochs ``start_epoch + 1 .. epochs`` with per-epoch test
        accuracy/AUC (reference ``train_rbm``); returns ``(loss_list,
        self, nll_list)`` of this call's epochs.

        The remainder batch is trained (when ``batch_size`` exceeds the
        set, the whole set is the remainder); PCD skips the ragged tail
        and refuses a set smaller than a batch.  One host fetch an epoch.
        ``reinit_on_collapse`` (0 = off, needs ``test_x``): every N epochs,
        re-draw a model that ``train.loop.flatlined`` (never after the
        final epoch).  ``checkpoint_every``: every N epochs the full state
        goes to ``checkpoint_path`` (``utils/checkpoint.py``); resuming
        from it with ``start_epoch`` continues bit for bit (not for PCD:
        its chain is not in the checkpoint)."""
        from qbmx_torch.train.loop import flatlined
        from qbmx_torch.utils.checkpoint import save_checkpoint
        from qbmx_torch.utils.metrics import History, accuracy_and_auc

        if checkpoint_every and self.method == "pcd":
            raise ValueError("checkpoint_every does not support method='pcd'"
                             " (persistent chain state is not checkpointed)")
        dev = self.device
        x = torch.as_tensor(_host_rows(train_x), device=dev)
        y = torch.as_tensor(np.asarray(train_y), device=dev)
        tx = torch.as_tensor(_host_rows(test_x), device=dev) if test_x is not None else None
        n = x.shape[0]
        is_pcd = self.method == "pcd"
        loss_list, nll_list = [], []
        for epoch_i in range(start_epoch + 1, epochs + 1):
            gen = self._epoch_generator()
            if shuffle:
                perm = torch.randperm(n, generator=gen, device=dev)
                xs, ys = x[perm], y[perm]
            else:
                xs, ys = x, y
            nb = n // batch_size
            if nb == 0 and is_pcd:
                raise ValueError(
                    f"batch_size={batch_size} exceeds the {n}-example "
                    "training set and method='pcd' skips ragged batches — "
                    "nothing would train; lower batch_size")
            if nb:
                xb = xs[: nb * batch_size].reshape(nb, batch_size, -1)
                yb = ys[: nb * batch_size].reshape(nb, batch_size)
            if is_pcd:
                # the chain carries across batches of one shape: the ragged
                # tail is skipped (the other methods train it)
                losses = []
                for b in range(nb):
                    self.params, loss, self._chain = self._step(
                        self.params, xb[b], yb[b], self.learning_rate, self._chain,
                        generator=gen)
                    losses.append(loss)
                mean_loss = torch.stack(losses).mean()
            else:
                if nb:
                    self.params, mean_loss = self._epoch(self.params, gen, xb, yb,
                                                         self.learning_rate)
                # remainder batch (the reference trains it too)
                if n % batch_size:
                    self.params, rloss = self._step(
                        self.params, xs[nb * batch_size:], ys[nb * batch_size:],
                        self.learning_rate, generator=gen)
                    if nb == 0:
                        mean_loss = rloss
            # the epoch's one host fetch: its loss and the test predictions
            preds = self._predict(tx) if tx is not None else mean_loss.new_zeros(0)
            host = torch.cat([mean_loss.reshape(1).float(), preds.float()]).cpu().numpy()
            mean_loss = float(host[0])
            loss_list.append(mean_loss)
            nll_list.append(mean_loss)
            self.nll_per_epoch_list.append(mean_loss)
            if tx is not None:
                acc, auc = accuracy_and_auc(np.asarray(test_y), host[1:].astype(np.int64))
                self.acc_per_epoch_list.append(acc)
                self.auc_per_epoch_list.append(auc)
                if (reinit_on_collapse and epoch_i % reinit_on_collapse == 0
                        and epoch_i < epochs
                        and flatlined(self.acc_per_epoch_list, test_y, reinit_on_collapse)):
                    self._reinit_attempt += 1
                    self.reinit_params(attempt=self._reinit_attempt)
            if checkpoint_every and checkpoint_path and epoch_i % checkpoint_every == 0:
                h = History(acc_per_epoch=list(self.acc_per_epoch_list),
                            auc_per_epoch=list(self.auc_per_epoch_list),
                            nll_per_epoch=list(self.nll_per_epoch_list))
                save_checkpoint(checkpoint_path, self, h, epoch_i)
        return loss_list, self, nll_list

    @torch.no_grad()
    def _predict(self, x: torch.Tensor) -> torch.Tensor:
        """Class predictions on the device (the first of tied maxima)."""
        return torch.argmax(predict_proba(self.params, x), dim=-1)

    def predict(self, x):
        """Class predictions for host inputs (image-shaped input accepted)."""
        return self._predict(torch.as_tensor(_host_rows(x), device=self.device)).cpu().numpy()

    def run_test_set(self, x, y):
        from qbmx_torch.utils.metrics import accuracy_and_auc

        return accuracy_and_auc(np.asarray(y), self.predict(x))

    def get_num_params(self):
        return sum(int(p.numel()) for p in tree_leaves(self.params))

    # -- weight pickles: the RBMParams fields in order, ``qbmx``'s format ----

    def weight_objects(self, params: RBMParams | None = None):
        d = params_to_numpy(params if params is not None else self.params)
        return [d[k] for k in FIELDS]

    def save_weights(self, title: str, path: str = "out"):
        save_weight_pickle(self.weight_objects(), title, path)

    def load_params(self, file_path):
        self.params = params_from_numpy(dict(zip(FIELDS, load_weight_pickle(file_path))),
                                        self.device)
