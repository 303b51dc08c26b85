"""The exact-gradient harness shared by the three enumeration studies
(``cdqbm_exact_study``, ``cdqbm_breast_exact_study``,
``cdqbm_multikernel_study``): p(y=1|x) by full Boltzmann enumeration of
the unclamped QUBO, the clipped NLL, Adam through the enumeration, and
the test metrics.

Counterpart of the copies of ``exact_p1``/``cdqbm_p1``/``dqbm_p1``,
``train_exact`` and ``evaluate``/``metrics``/``eval_metrics`` in
``qbmx``'s three study scripts, which run ``exact_boltzmann`` under
``jax.vmap`` and ``jax.value_and_grad`` with ``optax.adam``.  Here a batch
of images is one pass: the (N, 2ⁿ) energies of its QUBOs over
``enumerate_states(n)`` (n ≤ 15 in the studies), then a softmax a row,
and ``torch.autograd`` takes the gradient through it.

Each study starts from the very parameters ``qbmx`` draws for its seed
(the models draw them on the numpy threefry of ``core/threefry.py``), so
its table can be held row by row against ``qbmx``'s recorded one."""

from __future__ import annotations

import numpy as np
import torch

from qbmx_torch.models import dqbm
from qbmx_torch.models.base import tree_leaves, tree_map
from qbmx_torch.models.cdqbm import CDQBM, CDQBMParams
from qbmx_torch.samplers.exact import enumerate_states
from qbmx_torch.utils.metrics import _safe_auc

CLIP = 1e-7  # p(y=1|x) is clipped to [CLIP, 1 - CLIP] in the NLL, as the scripts' jnp.clip


def marginals(Q: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """(N, n) exact Boltzmann marginals of the QUBOs ``Q`` (N, n, n) at
    inverse temperature ``beta``: ``exact_boltzmann``'s marginals for each
    QUBO, its energies ``sᵀQs`` taken for the whole batch by one product
    with the states' pair products."""
    n = Q.shape[-1]
    states = enumerate_states(n, Q.device)  # (2ⁿ, n)
    pairs = (states[:, :, None] * states[:, None, :]).reshape(len(states), n * n)
    logp = -beta * (Q.reshape(-1, n * n) @ pairs.T)  # (N, 2ⁿ)
    probs = torch.exp(logp - torch.logsumexp(logp, dim=-1, keepdim=True))
    return probs @ states


def cdqbm_p1(model: CDQBM, params: CDQBMParams, x_imgs: torch.Tensor,
             beta: float = 1.0) -> torch.Tensor:
    """(N,) exact p(y=1|x) of a CDQBM with one label node for images
    ``x_imgs`` (N, H, W): the marginal of the output variable, which
    follows the hidden block."""
    return marginals(model.unclamped_qubo(params, x_imgs), beta)[:, model.geo.n_hidden]


def dqbm_p1(params: dqbm.DQBMParams, x_flat: torch.Tensor) -> torch.Tensor:
    """(N,) exact p(y=1|x) of a flat Disc_QBM with one output node for
    inputs ``x_flat`` (N, D): the output node leads the (out, hidden)
    layout."""
    return marginals(dqbm.unclamped_qubo(params, x_flat, 1.0))[:, 0]


def clipped_nll(p1: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean binary NLL of p(y=1|x) clipped to [CLIP, 1 - CLIP] (no
    gradient through a clipped entry)."""
    p1 = p1.clamp(CLIP, 1 - CLIP)
    return -(y * torch.log(p1) + (1 - y) * torch.log(1 - p1)).mean()


def _device(params) -> torch.device:
    return tree_leaves(params)[0].device


def adam(leaves, lr: float) -> torch.optim.Adam:
    """Adam with optax's defaults: β 0.9/0.999, eps 1e-8 (outside the
    square root)."""
    return torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def train_exact(p1_fn, params, X, Y, steps: int, lr: float):
    """``steps`` full-batch :func:`adam` steps on the clipped NLL of
    ``p1_fn(params, X)`` over every leaf of a copy of ``params``.  Returns ``(new params, the NLL of the last step)``
    -- the loss at the parameters that step updated, as the scripts'
    ``value_and_grad`` -- and leaves ``params`` as they were."""
    dev = _device(params)
    params = tree_map(lambda a: a.detach().clone().requires_grad_(True), params)
    X = torch.as_tensor(np.asarray(X, dtype=np.float32), device=dev)
    Y = torch.as_tensor(np.asarray(Y, dtype=np.float32), device=dev)
    opt = adam(tree_leaves(params), lr)
    loss = torch.zeros((), device=dev)
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = clipped_nll(p1_fn(params, X), Y)
        loss.backward()
        opt.step()
    return tree_map(lambda a: a.detach(), params), float(loss.detach())


def predict_p1(p1_fn, params, X, chunk: int = 64) -> np.ndarray:
    """p(y=1|x) for inputs ``X`` as a numpy array, ``chunk`` inputs a pass."""
    dev = _device(params)
    with torch.no_grad():
        return torch.cat([
            p1_fn(params, torch.as_tensor(np.asarray(X[i:i + chunk], dtype=np.float32),
                                          device=dev))
            for i in range(0, len(X), chunk)]).cpu().numpy()


def accuracy(p1: np.ndarray, Y) -> float:
    """The share of inputs whose p(y=1|x) > 0.5 matches the label."""
    return float(((p1 > 0.5).astype(np.float32) == Y).mean())


def eval_metrics(p1_fn, params, X, Y, chunk: int = 64) -> tuple[float, float]:
    """(accuracy, probability-scored AUC; 0.0 on a single class)."""
    p1 = predict_p1(p1_fn, params, X, chunk)
    return accuracy(p1, Y), float(_safe_auc(Y, p1))


