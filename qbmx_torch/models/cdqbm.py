"""Convolutional deep discriminative QBM (CDQBM) in PyTorch — counterpart of
``qbmx.models.cdqbm``.

One shared k×k conv kernel (or ``n_kernels`` of them) slid over the image,
each conv unit one patch; pooling windows over the conv feature map —
deterministic (the per-window argmin unit enters the QUBO) or probabilistic
(dedicated pool variables with at-most-one and OR-link QUBO penalties,
strength 0.8225); dense "sequential" hidden layers; and label node(s).
Training is clamped/unclamped moment matching over annealed QUBO samples,
as for the flat DQBM (``models/dqbm.py``).

The builders, the context and the moments work on a batch of images
(B, H, W) where ``qbmx`` vmaps a per-image function; each returns what
``jax.vmap`` of its ``qbmx`` counterpart returns, in the same float order
where the two packages' operations allow (``tests/test_torch_cdqbm.py``).
They also take parameters stacked over a leading seed axis S (every leaf
``(S, ...)``, the seed sweep's, ``train/sweep.SeedParallelCDQBM``) and
then return a leading S axis too, with the same number of device ops: the
images are shared, the parameters broadcast over them.
The feature map is a patch gather plus a float32 einsum, as in ``qbmx``, and
never ``F.conv2d``: cuDNN would run it in TF32 by default, and the argmin
pooling picks units on exact feature-map values.

Every per-example QUBO is ``<phase>_qubo_shared + diag(<phase>_fields)``:
the image enters only through the conv block's linear terms and the clamped
label only through the last hidden block's, which is the structured form
the samplers take (``sampler_sample_groups``).  At the CLI's probabilistic
shape (28×28, k=3, pool 4, ``--seq_sizes 4``) the unclamped QUBO has 717
variables, whose couplings exceed a block's shared memory: the samplers
run it on K4 (``csrc/anneal_wide.cu``).

Deviations from reference bugs, as in ``qbmx``: per-unit hidden biases are
applied, and for probabilistic pooling the kernel and per-unit bias
gradients use the conv-unit marginals.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from qbmx_torch.core import threefry
from qbmx_torch.core.rng import make_generator
from qbmx_torch.models.base import (
    EpochLaunchMixin,
    QBMModel,
    clip_by_global_norm,
    load_weight_pickle,
    pad_rows,
    resolve_device,
    tree_map,
)
from qbmx_torch.models.dqbm import SINGLE_DEVICE, StepSeams
from qbmx_torch.models.geometry import StackGeometry, patch_index_grid
from qbmx_torch.samplers.api import Sampler, get_sampler, sampler_sample_groups
from qbmx_torch.utils.spans import span, spanned

# Probabilistic pooling penalty strength, hard-coded in both reference
# generations (``src/model/cdqbm.py:69``, ``src/qubo/builder.py:26-27``).
PROB_POOL_PENALTY = 0.8225

ARRAY_FIELDS = ("kernel", "w_h2o", "w_oo", "b_conv", "b_seq", "b_o")


@dataclasses.dataclass
class CDQBMParams:
    kernel: torch.Tensor  # (n_kernels, k, k); n_kernels=1 = reference parity
    w_seq: tuple  # per layer: (prev_active, size)
    w_seq_intra: tuple  # per layer: (size, size) strictly upper; zeros if restricted
    w_h2o: torch.Tensor  # (last_hidden, n_out)
    w_oo: torch.Tensor  # (n_out, n_out) strictly upper
    b_conv: torch.Tensor  # (1,) shared | (conv_units_total,) per-unit | (1,) zeros for "none"
    b_seq: torch.Tensor  # (sum(seq),)
    b_o: torch.Tensor  # (n_out,)
    # learned per-window probabilistic-pooling penalties (``learn_penalty``):
    # (n_windows,), None when the flag is off
    pen: torch.Tensor | None = None


def params_from_numpy(p, device="cpu") -> CDQBMParams:
    """``CDQBMParams`` on ``device`` from anything with the nine fields as
    attributes or keys holding numpy-convertible arrays — a ``qbmx``
    ``CDQBMParams`` (tuples ``w_seq``/``w_seq_intra``, ``pen`` possibly
    ``None``) or :func:`params_to_numpy`'s dict."""
    get = (lambda k: p[k]) if isinstance(p, dict) else (lambda k: getattr(p, k))
    t = lambda a: torch.tensor(np.asarray(a, dtype=np.float32), device=device)
    pen = get("pen")
    return CDQBMParams(
        **{k: t(get(k)) for k in ARRAY_FIELDS},
        w_seq=tuple(t(w) for w in get("w_seq")),
        w_seq_intra=tuple(t(w) for w in get("w_seq_intra")),
        pen=None if pen is None else t(pen),
    )


def params_to_numpy(p: CDQBMParams) -> dict:
    """The nine fields as float32 numpy arrays (tuples for the per-layer
    weights, ``None`` for an absent ``pen``)."""
    q = tree_map(lambda a: a.detach().cpu().numpy(), p)
    return {f.name: getattr(q, f.name) for f in dataclasses.fields(q)}


def init_params(key: np.ndarray, geo: StackGeometry, hidden_bias_type: str,
                restricted: bool, learn_penalty: bool = False,
                prob_penalty: float = PROB_POOL_PENALTY, device="cpu") -> CDQBMParams:
    """U(-1, 1) init following ``Conv_Deep_QBM.init_weights``/``init_biases``
    (``src/model/cdqbm_state.py:140-190``): ``qbmx.models.cdqbm.init_params``'s
    draws from the same threefry ``key`` (``core/threefry.init_key``; one
    key a draw, in its order), bit for bit.  ``learn_penalty``: start the
    per-window penalty vector at ``prob_penalty``."""
    ks = iter(threefry.split(key, 8 + 2 * len(geo.seq_sizes)))
    u = lambda *shape: torch.as_tensor(threefry.uniform(next(ks), shape, -1.0, 1.0),
                                       device=device)
    k = geo.kernel_size

    w_seq, w_seq_intra = [], []
    prev = geo.n_pooled
    for size in geo.seq_sizes:
        w_seq.append(u(prev, size))
        w_seq_intra.append(torch.zeros(size, size, device=device) if restricted
                           else torch.triu(u(size, size), 1))
        prev = size

    if hidden_bias_type == "shared":
        b_conv = u(1)
    elif hidden_bias_type == "none":
        b_conv = torch.zeros(1, device=device)
    else:  # per-unit (one bias per conv unit per channel)
        b_conv = u(geo.conv_units_total)

    pen = None
    if learn_penalty:
        if geo.pooling_type != "probabilistic" or not geo.has_pooling:
            raise ValueError("learn_penalty requires probabilistic pooling")
        pen = torch.full((geo.n_windows,), prob_penalty, dtype=torch.float32, device=device)

    return CDQBMParams(
        kernel=u(geo.n_kernels, k, k),
        w_seq=tuple(w_seq),
        w_seq_intra=tuple(w_seq_intra),
        w_h2o=u(geo.last_hidden_size, geo.n_out),
        w_oo=torch.triu(u(geo.n_out, geo.n_out), 1),
        b_conv=b_conv,
        b_seq=u(sum(geo.seq_sizes)) if geo.seq_sizes else torch.zeros(0, device=device),
        b_o=u(geo.n_out),
        pen=pen,
    )


# ---------------------------------------------------------------------------
# Static penalty matrix (probabilistic pooling)
# ---------------------------------------------------------------------------


def build_penalty_basis(geo: StackGeometry) -> np.ndarray:
    """(n_windows, n_hidden, n_hidden) unit-strength per-window penalty
    patterns (upper-triangular, diagonal = linear terms): pairwise
    at-most-one within the window (``add_at_most_one_penalty_upper``,
    ``src/qubo/builder.py:116-124``) and the OR-link between the window's
    conv units and its pool variable (``add_link_penalty_upper``,
    ``src/qubo/builder.py:127-147``).  Window ``w`` is scaled by the
    constant 0.8225, or by the learned ``params.pen[w]`` under
    ``learn_penalty``."""
    if geo.pooling_type != "probabilistic" or not geo.has_pooling:
        return np.zeros((0, geo.n_hidden, geo.n_hidden), dtype=np.float32)
    windows = geo.pool_windows
    p_start = geo.conv_active  # first pool-var index
    basis = np.zeros((len(windows), geo.n_hidden, geo.n_hidden), dtype=np.float32)
    for g, ids in enumerate(windows):
        ids = np.asarray(ids, dtype=int)
        M = basis[g]
        # at-most-one among the window's conv units
        ii, jj = np.triu_indices(len(ids), k=1)
        M[ids[ii], ids[jj]] += 1.0
        # OR-link: pool var on iff some unit on
        pv = p_start + g
        M[pv, pv] += 1.0
        M[ids, ids] += 1.0
        M[ids, pv] += -2.0  # ids < pv always (conv block precedes pool vars)
    return basis


def build_penalty_matrix(geo: StackGeometry, penalty: float = PROB_POOL_PENALTY) -> np.ndarray:
    """(n_hidden, n_hidden) constant upper-triangular penalty terms — every
    window at the same strength (reference parity)."""
    basis = build_penalty_basis(geo)
    if not basis.shape[0]:
        return np.zeros((geo.n_hidden, geo.n_hidden), dtype=np.float32)
    return np.float32(penalty) * basis.sum(axis=0)


def _add_diag(Q: torch.Tensor, start: int, values: torch.Tensor) -> torch.Tensor:
    """Add ``values`` (..., m) to the diagonal of ``Q`` from ``start``, in
    place (``Q.at[idx, idx].add(values)``), batched over leading dims;
    returns ``Q``."""
    idx = torch.arange(start, start + values.shape[-1], device=Q.device)
    Q[..., idx, idx] += values
    return Q


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


class CDQBM(EpochLaunchMixin, QBMModel):
    """Stateful model holding the static geometry, its tables on the
    model's device, and the parameters, with ``qbmx``'s API surface (train
    via ``train/loop.train_model``, predict, save/load).

    Randomness comes from one CPU ``torch.Generator`` seeded from ``seed``:
    it draws the init and the samplers' seeds (the CUDA kernels key their
    Philox streams with them) or, on CPU, the samplers' variates."""

    #: where the training step meets its devices (``parallel.mesh.shard_model``
    #: sets a rank's)
    step_seams: StepSeams = SINGLE_DEVICE

    def __init__(
        self,
        image_shape=(28, 28),
        num_label_nodes: int = 1,
        seed: int = 77,
        kernel_size: int = 3,
        pooling_size: int = 0,
        pooling_type: str = "deterministic",
        stride: int = 1,
        sequential_layer_sizes=None,
        is_restricted: bool = False,
        hidden_bias_type: str = "none",
        solver: str = "SA",
        anneal: int = 1000,
        sample_count: int = 100,
        beta_eff: float = 1.0,
        sampler: Sampler | None = None,
        load_path: str = "",
        num_classes: int = 2,
        pool_select: str = "min",
        center_fmap: bool = False,
        prob_penalty: float = PROB_POOL_PENALTY,
        grad_clip: float = 0.0,
        learn_penalty: bool = False,
        sampler_kwargs: dict | None = None,
        n_kernels: int = 1,
        device="cuda",
    ):
        """Flag-gated extensions, off by default (reference parity), as in
        ``qbmx``: ``pool_select`` ("max"/"absmax" deterministic-pooling
        unit choice), ``center_fmap`` (zero-mean feature map per image),
        ``prob_penalty`` (the probabilistic-pooling strength),
        ``grad_clip`` (> 0 clips the update's global L2 norm),
        ``learn_penalty`` (a learned per-window penalty vector) and
        ``n_kernels`` (conv channels)."""
        if pool_select not in ("min", "max", "absmax"):
            raise ValueError(f"unknown pool_select {pool_select!r}")
        self.geo = StackGeometry(
            image_shape=tuple(image_shape),
            kernel_size=kernel_size,
            stride=stride,
            pooling_size=pooling_size,
            pooling_type=pooling_type,
            seq_sizes=tuple(sequential_layer_sizes or []),
            n_out=num_label_nodes,
            n_kernels=int(n_kernels),
        )
        self.seed = seed
        self.num_classes = num_classes
        self.n_output_nodes = num_label_nodes
        self.n_hidden_nodes = self.geo.n_hidden
        self.dim_input = image_shape[0] * image_shape[1]
        self.use_one_hot_encoding = num_label_nodes > 1
        self.is_restricted = is_restricted
        self.hidden_bias_type = hidden_bias_type
        self.sample_count = sample_count
        self.beta_eff = float(beta_eff)
        self.pool_select = pool_select
        self.center_fmap = bool(center_fmap)
        self.prob_penalty = float(prob_penalty)
        self.grad_clip = float(grad_clip)
        self.learn_penalty = bool(learn_penalty)
        self.solver_string = solver
        self.device = resolve_device(device)
        self.sampler = sampler if sampler is not None else get_sampler(
            solver, num_sweeps=anneal, **(sampler_kwargs or {}))

        # static tables on the device
        dev = self.device
        self.patch_idx = torch.as_tensor(patch_index_grid(image_shape, kernel_size, stride),
                                         device=dev)
        self.windows = (torch.as_tensor(self.geo.pool_windows, device=dev)
                        if self.geo.has_pooling else None)
        self.penalty_hidden = torch.as_tensor(build_penalty_matrix(self.geo, self.prob_penalty),
                                              device=dev)
        if self.learn_penalty:
            basis = build_penalty_basis(self.geo)
            self.pen_basis = torch.as_tensor(basis, device=dev)  # (W, nh, nh) upper-tri
            self.pen_basis_diag = torch.as_tensor(
                np.diagonal(basis, axis1=1, axis2=2).copy(), device=dev)  # (W, nh)
            self.pen_basis_upper = torch.as_tensor(np.triu(basis, k=1), device=dev)

        self.reinit_params(attempt=0)
        if load_path:
            self.load_params(load_path)
        self.training_history = None

    # -- context ---------------------------------------------------------------

    def _context(self, params: CDQBMParams, x_imgs: torch.Tensor):
        """(fmap_flat ([S,] B, C·U), pooled_idx ([S,] B, n_pooled), patches
        (B, U, k, k)) for images (B, H, W) — ``qbmx``'s per-image
        ``_context`` batched (``src/model/inference.py:16-44``)."""
        geo = self.geo
        B = x_imgs.shape[0]
        patches = x_imgs.reshape(B, -1)[:, self.patch_idx]  # (B, U, k, k)
        # ([S,] B, C, U) per-channel feature maps, flattened CHANNEL-MAJOR to
        # match the conv-block variable layout (StackGeometry.pool_windows)
        fmap = torch.einsum("bukl,...ckl->...bcu", patches, params.kernel)
        if self.center_fmap:
            fmap = fmap - fmap.mean(dim=-1, keepdim=True)
        fmap_flat = fmap.flatten(-2)
        if geo.pooling_type == "deterministic" and geo.has_pooling:
            wf = fmap_flat[..., self.windows]  # ([S,] B, n_win, p*p)
            if self.pool_select == "max":
                score = -wf
            elif self.pool_select == "absmax":
                score = -torch.abs(wf)
            else:  # "min" — reference parity (src/model/layers.py:77-84)
                score = wf
            amin = torch.argmin(score, dim=-1)  # first of equal minima, as jnp.argmin
            pooled_idx = torch.gather(self.windows.expand(*amin.shape, -1), -1,
                                      amin[..., None])[..., 0]
        else:
            pooled_idx = torch.arange(geo.conv_units_total, device=x_imgs.device) \
                .expand(*fmap_flat.shape[:-1], -1)
        return fmap_flat, pooled_idx, patches

    def _conv_linear_terms(self, params: CDQBMParams, ctx) -> torch.Tensor:
        """([S,] B, conv_active) linear terms of the conv block
        (``_conv_linear_terms``, ``src/qubo/builder.py:3-19``; per-unit biases
        applied)."""
        fmap_flat, pooled_idx, _ = ctx
        b_conv = params.b_conv[..., None, :]  # ([S,] 1, ·): broadcast over the examples
        if self.geo.pooling_type == "deterministic" and self.geo.has_pooling:
            base = torch.gather(fmap_flat, -1, pooled_idx)
            if self.hidden_bias_type == "shared":
                base = base + b_conv[..., :1]
            elif self.hidden_bias_type == "per-unit":
                base = base + torch.gather(b_conv.expand(*pooled_idx.shape[:-1], -1), -1,
                                           pooled_idx)
            return base
        base = fmap_flat
        if self.hidden_bias_type == "shared":
            base = base + b_conv[..., :1]
        elif self.hidden_bias_type == "per-unit":
            base = base + b_conv
        return base

    # -- QUBO builders -----------------------------------------------------------

    def _hidden_block(self, params: CDQBMParams, conv_bias: torch.Tensor) -> torch.Tensor:
        """(..., n_hidden, n_hidden) upper-triangular hidden block: penalties,
        conv diagonal ``conv_bias`` (..., conv_active), sequential
        inter/intra-layer weights and biases, in ``qbmx``'s order of
        additions.  Stacked ``params`` take a ``conv_bias`` of (S, conv_active)."""
        geo = self.geo
        n = geo.n_hidden
        Q = torch.zeros(conv_bias.shape[:-1] + (n, n), dtype=torch.float32,
                        device=conv_bias.device)
        if self.learn_penalty:
            # learned per-window strengths scale the static unit patterns
            Q = Q + torch.einsum("...w,wij->...ij", params.pen, self.pen_basis)
        else:
            Q = Q + self.penalty_hidden
        Q = _add_diag(Q, geo.conv_slice.start, conv_bias)

        prev_sl = geo.pool_slice
        for li, cur_sl in enumerate(geo.seq_slices):
            Q[..., prev_sl, cur_sl] += params.w_seq[li]
            if not self.is_restricted:
                Q[..., cur_sl, cur_sl] += torch.triu(params.w_seq_intra[li], 1)
            prev_sl = cur_sl

        if geo.seq_sizes:
            Q = _add_diag(Q, geo.conv_active + geo.n_pool_vars, params.b_seq)
        return Q

    def _label_fields(self, params: CDQBMParams, label_vec: torch.Tensor) -> torch.Tensor:
        """([S,] B, last_hidden) effective fields of the clamped labels."""
        return label_vec @ params.w_h2o.transpose(-1, -2)

    def _unclamped(self, params: CDQBMParams, Qh: torch.Tensor) -> torch.Tensor:
        """The (..., n_total, n_total) unclamped QUBO around hidden block ``Qh``."""
        geo = self.geo
        n = geo.n_total
        Q = torch.zeros(Qh.shape[:-2] + (n, n), dtype=torch.float32, device=Qh.device)
        Q[..., : geo.n_hidden, : geo.n_hidden] = Qh
        Q[..., geo.last_hidden_slice, geo.out_slice] += params.w_h2o
        Q[..., geo.out_slice, geo.out_slice] += torch.triu(params.w_oo, 1)
        return _add_diag(Q, geo.n_hidden, params.b_o) / self.beta_eff

    def clamped_qubo(self, params: CDQBMParams, x_imgs, label_vec, ctx=None):
        """(B, n_hidden, n_hidden) QUBOs with the labels clamped
        (``build_clamped_qubo``, ``src/qubo/builder.py:74-110``)."""
        ctx = ctx if ctx is not None else self._context(params, x_imgs)
        Q = self._hidden_block(params, self._conv_linear_terms(params, ctx))
        Q = _add_diag(Q, self.geo.last_hidden_slice.start, self._label_fields(params, label_vec))
        return Q / self.beta_eff

    def unclamped_qubo(self, params: CDQBMParams, x_imgs, ctx=None):
        """(B, n_total, n_total) QUBOs with free label nodes
        (``build_unclamped_qubo``, ``src/qubo/builder.py:21-71``)."""
        ctx = ctx if ctx is not None else self._context(params, x_imgs)
        return self._unclamped(params, self._hidden_block(params,
                                                          self._conv_linear_terms(params, ctx)))

    # Structured (shared-coupling) forms: ``<phase>_qubo(params, x, …) ==
    # <phase>_qubo_shared(params) + diag(<phase>_fields(params, x, …))``.

    def _zero_conv_bias(self, params: CDQBMParams) -> torch.Tensor:
        """([S,] conv_active) zeros, S the seed axis of ``params``."""
        return torch.zeros(params.b_o.shape[:-1] + (self.geo.conv_active,), device=self.device)

    def clamped_qubo_shared(self, params: CDQBMParams) -> torch.Tensor:
        """([S,] n_hidden, n_hidden) example-independent clamped-QUBO part."""
        return self._hidden_block(params, self._zero_conv_bias(params)) / self.beta_eff

    def clamped_fields(self, params: CDQBMParams, x_imgs, label_vec, ctx=None):
        """([S,] B, n_hidden) per-example linear terms of the clamped QUBO."""
        geo = self.geo
        ctx = ctx if ctx is not None else self._context(params, x_imgs)
        cb = self._conv_linear_terms(params, ctx)
        h = torch.zeros(cb.shape[:-1] + (geo.n_hidden,), dtype=torch.float32, device=cb.device)
        h[..., geo.conv_slice] += cb
        h[..., geo.last_hidden_slice] += self._label_fields(params, label_vec)
        return h / self.beta_eff

    def unclamped_qubo_shared(self, params: CDQBMParams) -> torch.Tensor:
        """([S,] n_total, n_total) example-independent unclamped-QUBO part."""
        return self._unclamped(params, self._hidden_block(params, self._zero_conv_bias(params)))

    def unclamped_fields(self, params: CDQBMParams, x_imgs, ctx=None):
        """([S,] B, n_total) per-example linear terms of the unclamped QUBO."""
        geo = self.geo
        ctx = ctx if ctx is not None else self._context(params, x_imgs)
        cb = self._conv_linear_terms(params, ctx)
        h = torch.zeros(cb.shape[:-1] + (geo.n_total,), dtype=torch.float32, device=cb.device)
        h[..., geo.conv_slice] += cb
        return h / self.beta_eff

    # -- moment estimation -----------------------------------------------------

    def _moments(self, params: CDQBMParams, samples, ctx, label_vec=None) -> CDQBMParams:
        """Per-example expected sufficient statistics (B leading, after the
        seed axis of stacked ``params``), shaped like the params
        (``get_average_configuration_single``, ``src/train/train.py:135-253``,
        with the probabilistic-pooling semantics of ``qbmx``).  ``samples``
        ([S,] B, R, n_hidden [+ n_out]); ``ctx`` of the same ``params``;
        ``label_vec`` (B, n_out), None for the unclamped phase."""
        geo = self.geo
        R = samples.shape[-2]
        _, pooled_idx, patches = ctx

        full = samples
        stats = full[..., geo.stats_drop:]  # drop conv cols for probabilistic
        E = stats.mean(dim=-2)  # ([S,] B, n_stats_hidden [+ n_out])
        lead = E.shape[:-1]  # ([S,] B)
        nsh = geo.n_stats_hidden
        sizes, starts = geo.sizes_active, geo.stats_starts

        # conv-unit marginals over the FULL channel-major conv grid (inactive
        # deterministically pooled units contribute exactly zero)
        if geo.n_pool_vars:
            Econv_full = full[..., : geo.conv_units_total].mean(dim=-2)
        else:
            Econv_full = torch.zeros(lead + (geo.conv_units_total,), device=samples.device) \
                .scatter_add(-1, pooled_idx, E[..., : geo.n_pooled])

        # per-channel kernel gradient (patch × E[h] accumulation,
        # src/train/train.py:188-192, one kernel per channel)
        g_kernel = torch.einsum("bukl,...bcu->...bckl", patches,
                                Econv_full.unflatten(-1, (geo.n_kernels, geo.num_conv_units)))

        if self.hidden_bias_type == "shared":
            g_b_conv = Econv_full.sum(dim=-1, keepdim=True)
        elif self.hidden_bias_type == "none":
            g_b_conv = torch.zeros(lead + params.b_conv.shape[-1:], device=samples.device)
        else:  # per-unit
            g_b_conv = Econv_full

        g_b_seq = E[..., geo.n_pooled: nsh] if geo.seq_sizes else \
            torch.zeros(lead + (0,), device=samples.device)

        g_w_seq, g_w_intra = [], []
        for li in range(len(geo.seq_sizes)):
            prev_b = stats[..., starts[li]: starts[li] + sizes[li]]
            cur_b = stats[..., starts[li + 1]: starts[li + 1] + sizes[li + 1]]
            g_w_seq.append(torch.einsum("...brp,...brc->...bpc", prev_b, cur_b) / R)
            g_w_intra.append(torch.triu(torch.einsum("...brc,...brd->...bcd", cur_b, cur_b) / R,
                                        1))

        last = stats[..., nsh - geo.last_hidden_size: nsh]
        if label_vec is None:
            ys = stats[..., nsh:]
            g_w_h2o = torch.einsum("...brh,...bro->...bho", last, ys) / R
            g_b_o = ys.mean(dim=-2)
            g_w_oo = torch.triu(torch.einsum("...bro,...brp->...bop", ys, ys) / R, 1)
        else:
            g_w_h2o = last.mean(dim=-2)[..., :, None] * label_vec[:, None, :]
            g_b_o = label_vec.expand(lead + label_vec.shape[-1:])
            g_w_oo = torch.triu(label_vec[:, :, None] * label_vec[:, None, :], 1) \
                .expand(lead + 2 * label_vec.shape[-1:])

        g_pen = None
        if self.learn_penalty:
            # E[sᵀ M_w s] with the diagonal carrying the linear terms
            hid = full[..., : geo.n_hidden]
            g_pen = (hid.mean(dim=-2) @ self.pen_basis_diag.T
                     + torch.einsum("...bri,wij,...brj->...bw", hid, self.pen_basis_upper,
                                    hid) / R)

        return CDQBMParams(kernel=g_kernel, w_seq=tuple(g_w_seq), w_seq_intra=tuple(g_w_intra),
                           w_h2o=g_w_h2o, w_oo=g_w_oo, b_conv=g_b_conv, b_seq=g_b_seq,
                           b_o=g_b_o, pen=g_pen)

    # -- training / prediction ---------------------------------------------------

    def _label_vec(self, y: torch.Tensor) -> torch.Tensor:
        if self.use_one_hot_encoding:
            return torch.nn.functional.one_hot(y.to(torch.int64), self.geo.n_out) \
                .to(torch.float32)
        return y.to(torch.float32)[:, None]

    def step_qubos(self, params: CDQBMParams, x_imgs, label_vec, ctx=None):
        """The step's one sampler call: ``(Q2 (2, n_total, n_total), h2 (2,
        B, n_total))``, both phases as two shared-coupling groups; the
        clamped group is zero-padded by n_out variables that couple to
        nothing and are sliced off.  With parameters stacked over S seeds
        ``(Q2 (2·S, ...), h2 (2·S, B, ...))``: every seed's clamped group,
        then every seed's unclamped group, ``qbmx``'s sweep order."""
        geo = self.geo
        ctx = ctx if ctx is not None else self._context(params, x_imgs)
        nh, nt, B = geo.n_hidden, geo.n_total, x_imgs.shape[0]
        lead = params.b_o.shape[:-1]  # the seed axis, if any
        Q2 = torch.zeros((2,) + lead + (nt, nt), dtype=torch.float32, device=x_imgs.device)
        Q2[0, ..., :nh, :nh] = self.clamped_qubo_shared(params)
        Q2[1] = self.unclamped_qubo_shared(params)
        h2 = torch.zeros((2,) + lead + (B, nt), dtype=torch.float32, device=x_imgs.device)
        h2[0, ..., :nh] = self.clamped_fields(params, x_imgs, label_vec, ctx)
        h2[1] = self.unclamped_fields(params, x_imgs, ctx)
        return Q2.flatten(0, len(lead)), h2.flatten(0, len(lead))

    @spanned("step")
    @torch.no_grad()
    def _step(self, x_imgs, y, mask, lr, seams: StepSeams | None = None):
        """One fused two-phase update of ``self.params`` on images (B, H, W);
        returns device scalars (nll, err).  ``seams``: where the step meets
        its devices (default ``self.step_seams``)."""
        seams = seams if seams is not None else self.step_seams
        x_imgs, y, mask = seams.rows(x_imgs, y, mask)
        generator = seams.generator(self)
        geo = self.geo
        p = self.params
        y_vec = self._label_vec(y)
        nh = geo.n_hidden
        ctx = self._context(p, x_imgs)
        Q2, h2 = self.step_qubos(p, x_imgs, y_vec, ctx)
        s_all = sampler_sample_groups(self.sampler, generator, Q2, h2,
                                      seams.reads(self.sample_count))
        s_c, s_u = s_all[0, :, :, :nh], s_all[1]

        mc = self._moments(p, s_c, ctx, y_vec)
        mu = self._moments(p, s_u, ctx)
        # NLL from unclamped output marginals (``nll_from_probs_binary``,
        # ``src/train/train.py:7-10``)
        grad, nll = seams.reduce(tree_map(torch.sub, mc, mu), mask,
                                 self._probs_from_samples(s_u), y)
        if self.is_restricted:
            grad.w_seq_intra = tuple(torch.zeros_like(w) for w in grad.w_seq_intra)
        if self.hidden_bias_type == "none":
            grad.b_conv = torch.zeros_like(grad.b_conv)
        if self.grad_clip > 0.0:
            grad = clip_by_global_norm(grad, self.grad_clip)
        self.params = tree_map(lambda a, g: a - lr * g, p, grad)
        return nll, grad.b_o.mean()

    def _probs_from_samples(self, s_u):
        """Unclamped samples (..., B, R, n_total) → (..., B, classes)
        probabilities."""
        geo = self.geo
        marg = s_u[..., geo.n_hidden:].mean(dim=-2)  # (..., B, n_out)
        if not self.use_one_hot_encoding:
            p1 = torch.clamp(marg[..., 0], 1e-12, 1 - 1e-12)
            return torch.stack([1.0 - p1, p1], dim=-1)
        tot = marg.sum(dim=-1, keepdim=True)
        return torch.where(tot > 0, marg / tot, torch.full_like(marg, 1.0 / geo.n_out))

    @torch.no_grad()
    def _predict_probs(self, x_imgs):
        p = self.params
        ctx = self._context(p, x_imgs)
        s_u = sampler_sample_groups(
            self.sampler, self.generator, self.unclamped_qubo_shared(p)[None],
            self.unclamped_fields(p, x_imgs, ctx)[None], self.sample_count)[0]
        return self._probs_from_samples(s_u)

    # -- functional pipeline API (reference src/train/pipeline.py parity) -------

    @torch.no_grad()
    def run_unclamped(self, x_img, num_reads=None, generator=None):
        """Single-image unclamped run → (samples, probs) numpy, mirroring
        ``run_unclamped`` (``src/train/pipeline.py:13-29``); a dense sampler
        call."""
        reads = num_reads or self.sample_count
        x = torch.as_tensor(np.asarray(x_img, dtype=np.float32), device=self.device)
        Qu = self.unclamped_qubo(self.params, x[None])
        s = self.sampler.sample_batch(generator or self.generator, Qu, reads)
        probs = self._probs_from_samples(s)
        return s[0].cpu().numpy(), probs[0].cpu().numpy()

    @torch.no_grad()
    def run_clamped(self, x_img, label_vec, num_reads=None, generator=None):
        """Single-image clamped run → samples numpy, mirroring ``run_clamped``
        (``src/train/pipeline.py:31-36``)."""
        reads = num_reads or self.sample_count
        x = torch.as_tensor(np.asarray(x_img, dtype=np.float32), device=self.device)
        lv = torch.as_tensor(np.asarray(label_vec, dtype=np.float32), device=self.device)
        Qc = self.clamped_qubo(self.params, x[None], lv.reshape(1, -1))
        return self.sampler.sample_batch(generator or self.generator, Qc, reads)[0].cpu().numpy()

    def _prepare_inputs(self, x: np.ndarray) -> np.ndarray:
        if x.ndim == 2:  # flattened input
            return x.reshape((-1,) + self.geo.image_shape)
        return x

    def train_for_one_iteration(self, x_batch, y_batch, learning_rate, mask=None):
        """One update on a batch (images or flat rows); returns device
        scalars (err, nll)."""
        x = torch.as_tensor(self._prepare_inputs(np.asarray(x_batch, dtype="float32")),
                            device=self.device)
        y = torch.as_tensor(np.asarray(y_batch), device=self.device)
        if mask is None:
            mask = torch.ones((x.shape[0],), dtype=torch.float32, device=self.device)
        else:
            mask = torch.as_tensor(np.asarray(mask, dtype="float32"), device=self.device)
        nll, err = self._step(x, y, mask, learning_rate)
        return err, nll

    @spanned("predict")
    def predict_batch(self, X, chunk: int = 32):
        """(predictions, class probabilities) for inputs ``X``, ``chunk``
        examples per sampler call (the ragged tail zero-padded to ``chunk``,
        as in ``qbmx``)."""
        x = self._cached_device_input(X)
        n = x.shape[0]
        outs = []
        for i in range(0, n, chunk):
            probs = self._predict_probs(pad_rows(x[i: i + chunk], chunk))
            with span("sync.val_fetch"):
                outs.append(probs.cpu().numpy())
        probs = np.concatenate(outs, axis=0)[:n]
        return np.argmax(probs, axis=1), probs

    @torch.no_grad()
    def get_last_hidden_embedding(self, X, chunk: int = 64):
        """Mean last-hidden-block activations per example, for coreset
        selection (``get_last_hidden_embedding``,
        ``src/model/cdqbm.py:1725-1736``): dense sampler calls on the
        unclamped QUBOs, ``chunk`` examples at a time."""
        x = torch.as_tensor(self._prepare_inputs(np.asarray(X, dtype="float32")),
                            device=self.device)
        ls = self.geo.last_hidden_slice
        n = x.shape[0]
        out = []
        for i in range(0, n, chunk):
            Qu = self.unclamped_qubo(self.params, pad_rows(x[i: i + chunk], chunk))
            s_u = self.sampler.sample_batch(self.generator, Qu, self.sample_count)
            out.append(s_u[:, :, ls].mean(dim=1).cpu().numpy())
        return np.concatenate(out, axis=0)[:n]

    # -- checkpointing -----------------------------------------------------------

    def weight_objects(self, params: CDQBMParams | None = None):
        """Reference ``weight_objects`` ordering (``src/model/cdqbm_state.py:40-47``),
        with a 9th entry, the learned penalties, under ``learn_penalty``."""
        d = params_to_numpy(params if params is not None else self.params)
        objs = [
            # n_kernels=1 checkpoints keep the reference's (k, k) kernel shape
            d["kernel"][0] if self.geo.n_kernels == 1 else d["kernel"],
            list(d["w_seq"]),
            d["w_h2o"],
            d["w_oo"],
            None if self.is_restricted else list(d["w_seq_intra"]),
            d["b_conv"],
            d["b_seq"],
            d["b_o"],
        ]
        if d["pen"] is not None:
            objs.append(d["pen"])
        return objs

    def reinit_params(self, attempt: int = 1) -> None:
        """Re-draw the parameters (``qbmx``'s for ``(seed, attempt)``) and the
        random stream (a generator that is a pure function of them); attempt
        0 is the initial draw."""
        self.generator = make_generator(self.seed, attempt)
        self.params = init_params(threefry.init_key(self.seed, attempt), self.geo,
                                  self.hidden_bias_type, self.is_restricted, self.learn_penalty,
                                  self.prob_penalty, self.device)

    def load_params(self, file_path):
        """Load a reference-format pickle: 8 entries, or 9 with learned
        penalties; a ``(k, k)`` kernel is a single-channel checkpoint."""
        loaded = load_weight_pickle(file_path)
        pen = None
        if len(loaded) == 9:  # learn_penalty checkpoints carry a 9th entry
            *loaded, pen = loaded
        kernel, w_seq, w_h2o, w_oo, w_intra, b_conv, b_seq, b_o = loaded
        kernel = np.asarray(kernel, np.float32)
        if kernel.ndim == 2:  # reference-format single-channel checkpoint
            kernel = kernel[None]
        if kernel.shape[0] != self.geo.n_kernels:
            raise ValueError(
                f"savepoint has {kernel.shape[0]} conv kernel(s) but the "
                f"model was built with n_kernels={self.geo.n_kernels}")
        if w_intra is None:
            w_intra = [np.zeros((s, s), np.float32) for s in self.geo.seq_sizes]
        self.params = params_from_numpy(
            dict(kernel=kernel, w_seq=w_seq, w_seq_intra=w_intra, w_h2o=w_h2o, w_oo=w_oo,
                 b_conv=b_conv, b_seq=b_seq, b_o=b_o, pen=pen), self.device)


def cdqbm_a_qubos(B: int, device, seed: int = 19):
    """CDQBM (a)'s step QUBOs (probabilistic pooling 4, ``--seq_sizes 4``,
    beta_eff 5: n = 717, J_g 98% zeros) on B random images made from
    ``seed``: (Q2 (2, n, n), h2 (2, B, n)), the clamped and unclamped
    groups of the step's one sampler call (:meth:`CDQBM.step_qubos`)."""
    m = CDQBM(pooling_size=4, pooling_type="probabilistic", sequential_layer_sizes=[4],
              hidden_bias_type="shared", solver="PT", beta_eff=5.0, seed=seed, device=device)
    x = torch.as_tensor(np.random.default_rng(seed).random((B, 28, 28), dtype=np.float32),
                        device=device)
    return m.step_qubos(m.params, x, m._label_vec(torch.arange(B, device=device) % 2))
