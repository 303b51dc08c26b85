"""Plain reference of the flat discriminative QBM (Disc_QBM): a label
unit, the image as clamped input, H hidden units.

Parameters are a dict of float32 tensors, each with a leading seed axis
S: ``w_vh`` (S, 1 + D, H) from [label, input] to the hidden units, ``w_vo``
(S, D, 1) from the input to the label, ``w_oo`` (S, 1, 1), ``b_h`` (S, H),
``b_o`` (S, 1), ``w_hh`` (S, H, H) among the hidden units (strictly upper).

A training step builds two QUBOs an example, both over β_eff: with the
label clamped to y, over the hidden units (linear terms ``b_h + [y, x]·
w_vh``, couplings ``w_hh``), and with it free, over [label, hidden]
(linear terms ``b_o + x·w_vo`` and ``b_h + x·w_vh[input rows]``, couplings
``w_oo``, ``w_vh[label row]``, ``w_hh``).  From the samples of each it
takes the data-weighted averages of every parameter's statistic (the unit
means and the products of the units it joins), and moves every parameter
by ``−lr·(clamped − unclamped)``, averaged over the valid rows of the
batch.  The loss is −log p(y), p(1) the free label's mean over the reads.
"""

from __future__ import annotations

import torch

from benchmark.reference.precision import FP32, Precision

LEAVES = ("w_vh", "w_vo", "w_oo", "b_h", "b_o", "w_hh")


def leaf_specs(model: dict) -> list[tuple]:
    """``(name, shape, kind)`` of every parameter, kind ``uniform``,
    ``upper`` (strictly upper triangle) or ``zeros``."""
    if model.get("use_one_hot_encoding"):
        raise ValueError("the reference takes a single label unit")
    D, H = model["dim_input"], model["n_hidden_nodes"]
    return [("w_vh", (1 + D, H), "uniform"), ("w_vo", (D, 1), "uniform"),
            ("w_oo", (1, 1), "upper"), ("b_h", (H,), "uniform"), ("b_o", (1,), "uniform"),
            ("w_hh", (H, H), "zeros" if model["restricted"] else "upper")]


def free_units(model: dict) -> dict:
    H = model["n_hidden_nodes"]
    return {"clamped": H, "unclamped": 1 + H}


def _label(y: torch.Tensor) -> torch.Tensor:
    return y.to(torch.float32)[:, None]


def _unclamped(p: dict, x: torch.Tensor, beta: float, prec: Precision):
    S, H = p["b_h"].shape
    h = torch.cat([p["b_o"][:, None, :] + prec.matmul(x, p["w_vo"]),
                   p["b_h"][:, None, :] + prec.matmul(x, p["w_vh"][:, 1:])], dim=-1)
    U = torch.zeros((S, 1 + H, 1 + H), device=h.device)
    U[:, :1, 1:] = p["w_vh"][:, :1]
    U[:, 1:, 1:] = torch.triu(p["w_hh"], 1)
    return h / beta, U / beta


def step_problems(p: dict, x, y, model: dict, prec: Precision = FP32) -> dict:
    """The step's QUBOs a phase: ``{phase: (h (S, B, n), U (S, n, n))}``."""
    beta = model["beta_eff"]
    v = torch.cat([_label(y), x], dim=-1)
    h_c = (p["b_h"][:, None, :] + prec.matmul(v, p["w_vh"])) / beta
    U_c = torch.triu(p["w_hh"], 1) / beta
    return {"clamped": (h_c, U_c), "unclamped": _unclamped(p, x, beta, prec)}


def predict_problems(p: dict, x, model: dict, prec: Precision = FP32):
    """The unclamped QUBOs of inputs ``x`` (N, D)."""
    return _unclamped(p, x, model["beta_eff"], prec)


def _moments(s, x, label, prec: Precision) -> dict:
    """Per-example statistics (S, B, ...) of samples ``s`` (S, B, R, ·):
    of the hidden units with the label clamped to ``label``, or of
    [label, hidden] with ``label`` None."""
    R = s.shape[2]
    lab = s[..., :1] if label is None else None
    hid = s if label is not None else s[..., 1:]
    Eh = hid.mean(2)
    Ehh = prec.einsum("sbri,sbrj->sbij", hid, hid) / R
    Ey = lab.mean(2) if lab is not None else label.expand(Eh.shape[0], -1, -1)
    Eyh = (prec.einsum("sbri,sbrj->sbij", lab, hid) / R if lab is not None
           else Ey[..., :, None] * Eh[..., None, :])
    Eyy = (prec.einsum("sbri,sbrj->sbij", lab, lab) / R if lab is not None
           else Ey[..., :, None] * Ey[..., None, :])
    xs = x.expand(Eh.shape[0], -1, -1)
    return {"w_vh": torch.cat([Eyh, xs[..., :, None] * Eh[..., None, :]], dim=2),
            "w_vo": xs[..., :, None] * Ey[..., None, :],
            "w_oo": torch.triu(Eyy, 1), "b_h": Eh, "b_o": Ey, "w_hh": torch.triu(Ehh, 1)}


def probs(s_u: torch.Tensor, model: dict) -> torch.Tensor:
    """Class probabilities (S, N, 2) from unclamped samples (S, N, R, ·)."""
    p1 = s_u[..., 0].mean(2).clamp(1e-12, 1 - 1e-12)
    return torch.stack([1.0 - p1, p1], dim=-1)


def update(p: dict, x, y, mask, lr: float, s_c, s_u, model: dict, prec: Precision = FP32):
    """One step from the samples of its two phases: ``(grad, new params,
    nll (S,))``."""
    label = _label(y)
    mc, mu = _moments(s_c, x, label, prec), _moments(s_u, x, None, prec)
    denom = mask.sum().clamp_min(1.0)
    grad = {}
    for k in LEAVES:
        d = mc[k] - mu[k]
        grad[k] = (d * mask.reshape((1, -1) + (1,) * (d.dim() - 2))).sum(1) / denom
    if model["restricted"]:
        grad["w_hh"] = torch.zeros_like(grad["w_hh"])
    new = {k: p[k] - lr * grad[k] for k in LEAVES}
    pr = probs(s_u, model)
    pick = torch.gather(pr, 2, y.long()[None, :, None].expand(pr.shape[0], -1, 1))[..., 0]
    nll = (-torch.log(pick + 1e-12) * mask).sum(1) / denom
    return grad, new, nll


def predictions(s_u: torch.Tensor, model: dict):
    """``(predictions (S, N), probabilities (S, N, 2))``: the free label's
    mean over the reads, rounded half to even."""
    return torch.round(s_u[..., 0].mean(2)).long(), probs(s_u, model)
