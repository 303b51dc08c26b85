"""Flat discriminative Quantum Boltzmann Machine (Disc_QBM) in PyTorch —
counterpart of ``qbmx.models.dqbm``.

Label node(s) + clamped analog input + H hidden units, trained by
clamped/unclamped two-phase moment matching over annealed QUBO samples.
The QUBO constructors and moment estimators are plain functions on tensors
with a leading batch dimension; ``DiscQBM`` holds its parameters as
tensors on its device and updates them under ``torch.no_grad()`` (the
update is a moment difference, no autograd).

QUBO layout (reference ``src/model/faster_dqbm.py:225-284``):
  * clamped (H×H): diag = hidden biases + concat(label, x) @ W_vh;
    strictly-upper = hidden-hidden couplings; ÷ beta_eff.
  * unclamped ((O+H)×(O+H)): outputs first — diag outputs = output biases +
    x @ W_vo, diag hiddens = hidden biases + x @ W_vh[input rows]; upper
    blocks = output-output couplings, label-row W_vh, hidden-hidden
    couplings; ÷ beta_eff.
Every per-example QUBO is ``<phase>_qubo_shared + diag(<phase>_fields)``:
the couplings come from the parameters alone, which is the structured form
the samplers take (``sampler_sample_groups``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from qbmx_torch.core import threefry
from qbmx_torch.core.rng import make_generator, rand
from qbmx_torch.models.base import (
    EpochLaunchMixin,
    QBMModel,
    clip_by_global_norm,
    load_weight_pickle,
    resolve_device,
    tree_map,
)
from qbmx_torch.samplers.api import (Sampler, get_sampler, sampler_sample_groups,
                                     with_dense_couplings)
from qbmx_torch.utils.spans import span, spanned

FIELDS = ("w_vh", "w_vo", "w_oo", "b_h", "b_o", "w_hh")


@dataclasses.dataclass
class DQBMParams:
    """Parameters; ``w_hh`` is all-zero (and frozen) when restricted."""

    w_vh: torch.Tensor  # (n_out + dim_input, H): rows = [label nodes..., input...]
    w_vo: torch.Tensor  # (dim_input, n_out)
    w_oo: torch.Tensor  # (n_out, n_out), strictly upper
    b_h: torch.Tensor  # (H,)
    b_o: torch.Tensor  # (n_out,)
    w_hh: torch.Tensor  # (H, H), strictly upper; zeros if restricted


def params_from_numpy(d, device="cpu") -> DQBMParams:
    """``DQBMParams`` on ``device`` from a mapping of the six fields to
    numpy arrays (e.g. the fields of a ``qbmx`` ``DQBMParams``)."""
    return DQBMParams(**{k: torch.tensor(np.asarray(d[k], dtype=np.float32), device=device)
                         for k in FIELDS})


def params_to_numpy(p: DQBMParams) -> dict:
    """The six fields as float32 numpy arrays."""
    return {k: getattr(p, k).detach().cpu().numpy() for k in FIELDS}


def init_params(key: np.ndarray, dim_input: int, n_hidden: int, n_out: int,
                restricted: bool, device="cpu") -> DQBMParams:
    """U(-1, 1) init: ``qbmx.models.dqbm.init_params``'s draws from the same
    threefry ``key`` (``core/threefry.init_key``), bit for bit."""
    ks = threefry.split(key, 6)
    u = lambda i, *shape: torch.as_tensor(threefry.uniform(ks[i], shape, -1.0, 1.0),
                                          device=device)
    H = n_hidden
    return DQBMParams(
        w_vh=u(0, n_out + dim_input, H), w_vo=u(1, dim_input, n_out),
        w_oo=torch.triu(u(2, n_out, n_out), 1), b_h=u(3, H), b_o=u(4, n_out),
        w_hh=torch.zeros(H, H, device=device) if restricted else torch.triu(u(5, H, H), 1),
    )


# ---------------------------------------------------------------------------
# QUBO constructors (x: (B, D), y_vec: (B, O))
# ---------------------------------------------------------------------------


def clamped_qubo(params: DQBMParams, x, y_vec, beta_eff: float):
    """(B, H, H) QUBOs over the hidden units with visibles clamped to (label, x)."""
    v = torch.cat([y_vec, x], dim=-1)  # label rows first, as in the weight matrix
    diag = params.b_h + v @ params.w_vh
    return (torch.diag_embed(diag) + torch.triu(params.w_hh, 1)) / beta_eff


def unclamped_qubo(params: DQBMParams, x, beta_eff: float):
    """(B, O+H, O+H) QUBOs over (outputs, hiddens) with the input clamped to x."""
    n_out = params.b_o.shape[0]
    diag = torch.cat([params.b_o + x @ params.w_vo,
                      params.b_h + x @ params.w_vh[n_out:]], dim=-1)
    return (torch.diag_embed(diag) + _unclamped_couplings(params)) / beta_eff


def _unclamped_couplings(params: DQBMParams):
    n_out = params.b_o.shape[-1]
    H = params.b_h.shape[-1]
    Q = params.b_h.new_zeros(params.b_h.shape[:-1] + (n_out + H, n_out + H))
    Q[..., :n_out, :n_out] = torch.triu(params.w_oo, 1)
    Q[..., :n_out, n_out:] = params.w_vh[..., :n_out, :]
    Q[..., n_out:, n_out:] = torch.triu(params.w_hh, 1)
    return Q


# The shared parts and the fields also take parameters stacked over a
# leading seed axis (``train/sweep.py``): (S, ...) parameters give (S, ...)
# QUBOs and (S, B, ...) fields.


def clamped_qubo_shared(params: DQBMParams, beta_eff: float):
    """(H, H) example-independent part of the clamped QUBO."""
    return (torch.diag_embed(params.b_h) + torch.triu(params.w_hh, 1)) / beta_eff


def clamped_fields(params: DQBMParams, x, y_vec, beta_eff: float):
    """(B, H) per-example linear terms of the clamped QUBO."""
    return (torch.cat([y_vec, x], dim=-1) @ params.w_vh) / beta_eff


def unclamped_qubo_shared(params: DQBMParams, beta_eff: float):
    """((O+H), (O+H)) example-independent part of the unclamped QUBO."""
    diag = torch.diag_embed(torch.cat([params.b_o, params.b_h], dim=-1))
    return (diag + _unclamped_couplings(params)) / beta_eff


def unclamped_fields(params: DQBMParams, x, beta_eff: float):
    """(B, O+H) per-example linear terms of the unclamped QUBO."""
    n_out = params.b_o.shape[-1]
    return torch.cat([x @ params.w_vo, x @ params.w_vh[..., n_out:, :]], dim=-1) / beta_eff


# ---------------------------------------------------------------------------
# Moment estimation (per example, averaged over reads)
# ---------------------------------------------------------------------------


def clamped_moments(s_h, x, y_vec) -> DQBMParams:
    """Clamped-phase statistics from hidden samples ``s_h`` (B, R, H)."""
    Eh = s_h.mean(dim=1)
    Ehh = torch.einsum("brh,brk->bhk", s_h, s_h) / s_h.shape[1]
    v = torch.cat([y_vec, x], dim=1)
    return DQBMParams(
        w_vh=v[:, :, None] * Eh[:, None, :],
        w_vo=x[:, :, None] * y_vec[:, None, :],
        w_oo=torch.triu(y_vec[:, :, None] * y_vec[:, None, :], 1),
        b_h=Eh,
        b_o=y_vec,
        w_hh=torch.triu(Ehh, 1),
    )


def unclamped_moments(s, x, n_out: int) -> DQBMParams:
    """Unclamped-phase statistics from samples ``s`` (B, R, O+H)."""
    R = s.shape[1]
    y_s, h_s = s[:, :, :n_out], s[:, :, n_out:]
    Ey, Eh = y_s.mean(dim=1), h_s.mean(dim=1)
    Eyh = torch.einsum("bro,brh->boh", y_s, h_s) / R
    Eyy = torch.einsum("bro,brp->bop", y_s, y_s) / R
    Ehh = torch.einsum("brh,brk->bhk", h_s, h_s) / R
    return DQBMParams(
        w_vh=torch.cat([Eyh, x[:, :, None] * Eh[:, None, :]], dim=1),
        w_vo=x[:, :, None] * Ey[:, None, :],
        w_oo=torch.triu(Eyy, 1),
        b_h=Eh,
        b_o=Ey,
        w_hh=torch.triu(Ehh, 1),
    )


def _masked_mean(tree, mask):
    """Batch average of per-example statistics honoring a validity mask
    (the padded tail of the final partial batch contributes zero)."""
    denom = torch.clamp(mask.sum(), min=1.0)

    def avg(leaf):
        m = mask.reshape((-1,) + (1,) * (leaf.dim() - 1))
        return (leaf * m).sum(dim=0) / denom

    return tree_map(avg, tree)


# ---------------------------------------------------------------------------
# Loss / prediction helpers
# ---------------------------------------------------------------------------


def output_probs_from_samples(s_u, n_out: int, one_hot: bool):
    """Unclamped samples → class probabilities: ``[1-p1, p1]`` from the
    single output node's mean, or the normalized one-hot marginals."""
    marg = s_u[:, :, :n_out].mean(dim=1)
    if not one_hot:
        p1 = torch.clamp(marg[:, 0], 1e-12, 1 - 1e-12)
        return torch.stack([1.0 - p1, p1], dim=1)
    tot = marg.sum(dim=1, keepdim=True)
    return torch.where(tot > 0, marg / tot, torch.full_like(marg, 1.0 / n_out))


def nll_from_probs(probs, y, mask):
    """Mean −log p(y) over the valid examples."""
    p = torch.gather(probs, 1, y[:, None].to(torch.int64))[:, 0]
    nll = -torch.log(p + 1e-12)
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


class StepSeams:
    """Where a training step (``DiscQBM._step``, ``CDQBM._step``) meets the
    devices it runs on; these are one device's: every row of the batch,
    the model's own generator, every read, the masked batch mean.
    ``parallel.mesh.MeshSeams`` is a rank's."""

    shortcut = True  # the restricted linear shortcut may be taken

    def rows(self, *tensors):
        return tensors

    def generator(self, model) -> torch.Generator:
        return model.generator

    def reads(self, count: int) -> int:
        return count

    def reduce(self, diff, mask, probs, y):
        """``(grad, nll)``: the masked batch means of the per-example moment
        differences and of −log p(y)."""
        return _masked_mean(diff, mask), nll_from_probs(probs, y, mask)


SINGLE_DEVICE = StepSeams()


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


class DiscQBM(EpochLaunchMixin, QBMModel):
    """Stateful model with the reference's API surface (train_model /
    predict / save_weights / load_savepoint).

    Randomness comes from one CPU ``torch.Generator`` seeded from ``seed``:
    it draws the init, the linear-shortcut coins and the samplers' seeds
    (the CUDA kernel keys its Philox streams with them) or, on CPU, the
    samplers' variates."""

    #: where the training step meets its devices (``parallel.mesh.shard_model``
    #: sets a rank's)
    step_seams: StepSeams = SINGLE_DEVICE

    def __init__(
        self,
        dim_input: int,
        num_classes: int = 2,
        n_hidden_nodes: int = 4,
        seed: int = 77,
        solver: str = "SA",
        restricted: bool = False,
        sample_count: int = 20,
        anneal_steps: int = 20,
        beta_eff: float = 1.0,
        use_one_hot_encoding: bool = False,
        sampler: Sampler | None = None,
        load_path: str = "",
        use_linear_shortcut: bool = False,
        grad_clip: float = 0.0,
        sampler_kwargs: dict | None = None,
        device="cuda",
    ):
        """``use_linear_shortcut``: when restricted, the clamped QUBO is
        diagonal and its ground state closed-form — skip sampling that
        phase.  ``grad_clip`` > 0 clips the update's global L2 norm."""
        self.dim_input = dim_input
        self.num_classes = num_classes
        self.n_hidden_nodes = n_hidden_nodes
        self.n_output_nodes = num_classes if use_one_hot_encoding else 1
        self.use_one_hot_encoding = use_one_hot_encoding
        self.restricted = restricted
        self.use_linear_shortcut = use_linear_shortcut and restricted
        self.sample_count = sample_count
        self.anneal_steps = anneal_steps
        self.beta_eff = float(beta_eff)
        self.seed = seed
        self.grad_clip = float(grad_clip)
        self.solver_string = solver
        self.device = resolve_device(device)
        # unrestricted, J_g holds the dense w_hh: K4 need not count its nonzeros
        self.sampler = sampler if sampler is not None else with_dense_couplings(get_sampler(
            solver, num_sweeps=anneal_steps, **(sampler_kwargs or {})), not restricted)
        self.reinit_params(attempt=0)
        if load_path:
            self.load_savepoint(load_path)

    # -- computations ---------------------------------------------------------

    def step_qubos(self, params: DQBMParams, x, y_vec):
        """The step's one sampler call (without the linear shortcut): ``(Q2
        (2, n_u, n_u), h2 (2, B, n_u))``, both phases as two shared-coupling
        groups; the clamped group is zero-padded to the unclamped size (the
        padding variables couple to nothing and are sliced off)."""
        beta, B, H = self.beta_eff, x.shape[0], params.b_h.shape[0]
        Qu_sh = unclamped_qubo_shared(params, beta)
        hu = unclamped_fields(params, x, beta)
        n_u = Qu_sh.shape[-1]
        Q2 = torch.zeros((2, n_u, n_u), dtype=Qu_sh.dtype, device=Qu_sh.device)
        Q2[0, :H, :H] = clamped_qubo_shared(params, beta)
        Q2[1] = Qu_sh
        h2 = torch.zeros((2, B, n_u), dtype=hu.dtype, device=hu.device)
        h2[0, :, :H] = clamped_fields(params, x, y_vec, beta)
        h2[1] = hu
        return Q2, h2

    def _label_vec(self, y: torch.Tensor) -> torch.Tensor:
        if self.use_one_hot_encoding:
            return torch.nn.functional.one_hot(y.to(torch.int64), self.n_output_nodes) \
                .to(torch.float32)
        return y.to(torch.float32)[:, None]

    def _sampler_call_groups(self) -> int:
        """Groups in the step's one sampler call: the linear-shortcut step
        samples the unclamped phase alone, the normal step (and a sharded
        one) both phases."""
        return 1 if self.use_linear_shortcut and self.step_seams.shortcut else 2

    @spanned("step")
    @torch.no_grad()
    def _step(self, x, y, mask, lr, seams: StepSeams | None = None):
        """One fused two-phase update of ``self.params``; returns device
        scalars (nll, err).  ``seams``: where the step meets its devices
        (default ``self.step_seams``)."""
        seams = seams if seams is not None else self.step_seams
        x, y, mask = seams.rows(x, y, mask)
        generator = seams.generator(self)
        p = self.params
        n_out, beta, reads = self.n_output_nodes, self.beta_eff, seams.reads(self.sample_count)
        y_vec = self._label_vec(y)
        B, H = x.shape[0], p.b_h.shape[0]
        if self.use_linear_shortcut and seams.shortcut:
            # restricted clamped QUBO is diagonal: its ground state in closed
            # form, one fair coin per zero-bias unit, replicated across reads
            diag = torch.diagonal(clamped_qubo(p, x, y_vec, beta), dim1=-2, dim2=-1)
            coin = (rand(diag.shape, generator, diag.device) < 0.5).to(torch.float32)
            gs = torch.where(diag < 0, 1.0, torch.where(diag > 0, 0.0, coin))
            s_c = gs[:, None, :].expand(B, reads, H)
            s_u = sampler_sample_groups(self.sampler, generator,
                                        unclamped_qubo_shared(p, beta)[None],
                                        unclamped_fields(p, x, beta)[None], reads)[0]
        else:
            Q2, h2 = self.step_qubos(p, x, y_vec)
            s_all = sampler_sample_groups(self.sampler, generator, Q2, h2, reads)
            s_c, s_u = s_all[0, :, :, :H], s_all[1]

        mc = clamped_moments(s_c, x, y_vec)
        mu = unclamped_moments(s_u, x, n_out)
        probs = output_probs_from_samples(s_u, n_out, self.use_one_hot_encoding)
        grad, nll = seams.reduce(tree_map(torch.sub, mc, mu), mask, probs, y)
        if self.restricted:
            grad.w_hh = torch.zeros_like(grad.w_hh)
        if self.grad_clip > 0.0:
            grad = clip_by_global_norm(grad, self.grad_clip)
        # gradient DESCENT on (clamped − unclamped), reference
        # ``src/model/faster_dqbm.py:1051-1059``
        self.params = tree_map(lambda a, g: a - lr * g, p, grad)
        return nll, grad.b_o.mean()

    @torch.no_grad()
    def _predict_probs(self, x):
        p = self.params
        s_u = sampler_sample_groups(
            self.sampler, self.generator, unclamped_qubo_shared(p, self.beta_eff)[None],
            unclamped_fields(p, x, self.beta_eff)[None], self.sample_count)[0]
        marg = s_u[:, :, :self.n_output_nodes].mean(dim=1)
        return marg, output_probs_from_samples(s_u, self.n_output_nodes,
                                               self.use_one_hot_encoding)

    def train_for_one_iteration(self, x_batch, y_batch, learning_rate, mask=None):
        """One update on a batch; returns device scalars (err, nll)."""
        x = torch.as_tensor(np.asarray(x_batch, dtype="float32"), device=self.device)
        y = torch.as_tensor(np.asarray(y_batch), device=self.device)
        if mask is None:
            mask = torch.ones((x.shape[0],), dtype=torch.float32, device=self.device)
        else:
            mask = torch.as_tensor(np.asarray(mask, dtype="float32"), device=self.device)
        nll, err = self._step(x, y, mask, learning_rate)
        return err, nll

    @spanned("predict")
    def predict_batch(self, X):
        """(predictions, class probabilities) for inputs ``X`` (N, D):
        rounded (binary) or argmaxed (one-hot) unclamped output marginals."""
        marg, probs = self._predict_probs(self._cached_device_input(X))
        with span("sync.val_marg"):
            marg = marg.cpu().numpy()
        if self.use_one_hot_encoding:
            preds = np.argmax(marg, axis=1)
        else:
            preds = np.round(marg[:, 0]).astype(int)
        with span("sync.val_probs"):
            probs = probs.cpu().numpy()
        return preds, probs

    def get_result_distribution(self, samples_of_output_list, all_possible_patterns):
        """Empirical distribution over output-node bit patterns."""
        from collections import Counter

        if self.use_one_hot_encoding:
            keys = ["".join(str(int(v)) for v in s) for s in samples_of_output_list]
        else:
            keys = [str(int(v)) for v in np.asarray(samples_of_output_list).ravel()]
        counts = Counter(keys)
        total = sum(counts.values())
        probs = {k: v / total for k, v in counts.items()} if total else {}
        return [probs.get(p, 0.0) for p in all_possible_patterns]

    @torch.no_grad()
    def sample_output_patterns(self, X):
        """Unclamped output-node samples for each input (dense sampler call)."""
        x = torch.as_tensor(np.asarray(X, dtype="float32"), device=self.device)
        Qu = unclamped_qubo(self.params, x, self.beta_eff)
        s_u = self.sampler.sample_batch(self.generator, Qu, self.sample_count)
        return s_u[:, :, :self.n_output_nodes].cpu().numpy().reshape(-1, self.n_output_nodes)

    # -- checkpointing (reference pickle format) -------------------------------

    def weight_objects(self, params: DQBMParams | None = None):
        """Reference ``weight_objects`` ordering (``src/model/faster_dqbm.py:90-94``)."""
        d = params_to_numpy(params if params is not None else self.params)
        objs = [d["w_vh"], d["w_vo"], d["b_h"], d["b_o"], d["w_oo"]]
        if not self.restricted:
            objs.append(d["w_hh"])
        return objs

    def reinit_params(self, attempt: int = 1) -> None:
        """Re-draw the parameters (``qbmx``'s for ``(seed, attempt)``) and the
        random stream (a generator that is a pure function of them); attempt
        0 is the initial draw."""
        self.generator = make_generator(self.seed, attempt)
        self.params = init_params(threefry.init_key(self.seed, attempt), self.dim_input,
                                  self.n_hidden_nodes, self.n_output_nodes, self.restricted,
                                  self.device)

    def load_savepoint(self, savepoint):
        """Load reference-format checkpoints: 5-tuple (restricted) or 6-tuple
        (fully connected), ``src/model/faster_dqbm.py:169-190``."""
        loaded = load_weight_pickle(savepoint, "Savepoint file not found")
        if len(loaded) not in (5, 6):
            raise ValueError(f"expected 5- or 6-tuple checkpoint, got {len(loaded)}")
        w_vh, w_vo, b_h, b_o, w_oo = loaded[:5]
        want_vh = (self.n_output_nodes + self.dim_input, self.n_hidden_nodes)
        got_vh = np.shape(w_vh)
        if tuple(got_vh) != want_vh:
            raise ValueError(
                f"{savepoint}: visible->hidden weights are {tuple(got_vh)} but this "
                f"model expects {want_vh} (dim_input={self.dim_input}, "
                f"n_hidden_nodes={self.n_hidden_nodes}, "
                f"n_output_nodes={self.n_output_nodes}) — construct the model with "
                "the hyperparameters the pickle was trained with")
        if len(loaded) == 6 and self.restricted:
            raise ValueError(
                f"{savepoint} is a 6-tuple (fully connected, hidden-hidden "
                "couplings present) but this model is restricted=True — "
                "pass restricted=False to load it")
        w_hh = loaded[5] if len(loaded) == 6 else np.zeros((self.n_hidden_nodes,) * 2)
        self.params = params_from_numpy(
            dict(w_vh=w_vh, w_vo=w_vo, w_oo=w_oo, b_h=b_h, b_o=b_o, w_hh=w_hh),
            self.device)
