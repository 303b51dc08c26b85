"""Cross-model warm starts: a trained RBM → a discriminative QBM
(counterpart of ``qbmx.models.warmstart``).

Pre-train a ``ClassificationRBM`` cheaply with the exact or CD gradient,
then map its parameters onto a flat ``DiscQBM`` and go on with
annealer-sampled moment matching.

Mapping (energy-sign aware): the RBM's joint energy is
``-E = x·W·h + c·h + d·y + y·U·h (+ b·x)`` while the QBM's QUBO is a
*minimized* energy of the same structure, so every RBM parameter maps with
a sign flip:

    w_vh[label rows]  = -U          (class→hidden couplings)
    w_vh[input rows]  = -W          (input→hidden couplings)
    b_h               = -c
    b_o               = -d
    w_vo, w_oo, w_hh  = 0           (absent from an RBM)

With one-hot QBM labels the mapping is exact; with a single binary output
node the two class columns collapse to their difference (class1 − class0)
and class 0's couplings move into the hidden bias, which keeps the
discriminative decision function.
"""

from __future__ import annotations

import torch

from qbmx_torch.models.dqbm import DiscQBM, DQBMParams
from qbmx_torch.models.rbm import RBMParams


def rbm_to_dqbm_params(rbm_params: RBMParams, use_one_hot: bool) -> DQBMParams:
    W = rbm_params.weights  # (V, H)
    U = rbm_params.class_weights  # (C, H)
    c = rbm_params.hidden_bias  # (H,)
    d = rbm_params.class_bias  # (C,)
    V, H = W.shape
    if use_one_hot:
        label_rows, b_o, b_h = -U, -d, -c
    else:
        if U.shape[0] != 2:
            raise ValueError("binary-node warm start needs a 2-class RBM")
        # exact collapse: absorb class-0 contributions into the hidden bias
        # so s=0 reproduces the y=0 conditionals and s=1 the y=1 ones
        label_rows = -(U[1] - U[0])[None, :]
        b_o = (-(d[1] - d[0]))[None]
        b_h = -(c + U[0])
    n_out = label_rows.shape[0]
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=W.device)
    return DQBMParams(
        w_vh=torch.cat([label_rows, -W], dim=0),
        w_vo=zeros(V, n_out),
        w_oo=zeros(n_out, n_out),
        b_h=b_h,
        b_o=b_o,
        w_hh=zeros(H, H),
    )


def warm_start_dqbm(rbm, **dqbm_kwargs) -> DiscQBM:
    """A ``DiscQBM`` on the RBM's device whose parameters come from a
    trained ``ClassificationRBM``; training then goes on with sampled
    gradients.  ``use_one_hot_encoding`` defaults to one-hot for more than
    two classes."""
    use_one_hot = dqbm_kwargs.pop("use_one_hot_encoding", rbm.num_classes > 2)
    dqbm_kwargs.setdefault("device", rbm.device)
    model = DiscQBM(
        dim_input=rbm.num_visible,
        num_classes=rbm.num_classes,
        n_hidden_nodes=rbm.num_hidden,
        use_one_hot_encoding=use_one_hot,
        **dqbm_kwargs,
    )
    model.params = rbm_to_dqbm_params(rbm.params, use_one_hot)
    return model
