"""Plain reference of the convolutional deep QBM (CDQBM) with
probabilistic pooling: one shared k×k kernel slid over the image, a
conv unit a patch; non-overlapping p×p pooling windows, each with a pool
unit; dense "sequential" hidden layers after the pool units; one label
unit.

Units, in order: the conv units (row-major over the feature map), the
pool units (one a window, row-major), each sequential layer, the label.
Couplings: within a window, every pair of conv units ``+c`` (at most
one on) and each conv unit with the pool unit ``−2c``, with ``+c`` on the
linear terms of both (the pool unit is on iff a unit of its window is),
c = ``prob_penalty``; pool units to the first layer ``w_seq[0]``, layer
l−1 to l ``w_seq[l]``, within a layer ``w_seq_intra[l]`` (strictly
upper); the last layer to the label ``w_h2o``.  Linear terms: a conv unit
``patch·kernel + b_conv`` (one shared bias), the layers ``b_seq``, the
label ``b_o``; with the label clamped to y, the last layer also gets
``y·w_h2o``.  Everything over β_eff.

Statistics (the reference QBM code's, as the port keeps them): the conv
units' means give the kernel's (``Σ_u E[s_u]·patch_u``) and the bias's
(``Σ_u E[s_u]``); the pool units stand for the pooled layer, whose
products with the first layer give ``w_seq[0]``'s.  Parameters are a
dict with a leading seed axis S: ``kernel`` (S, 1, k, k), ``w_seq.l``,
``w_seq_intra.l``, ``w_h2o`` (S, last, 1), ``w_oo`` (S, 1, 1), ``b_conv`` (S,
1), ``b_seq`` (S, Σ sizes), ``b_o`` (S, 1).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference.precision import FP32, Precision


@dataclasses.dataclass(frozen=True)
class Layout:
    image: tuple
    k: int
    stride: int
    pool: int
    seq: tuple

    @classmethod
    def of(cls, model: dict) -> "Layout":
        if (model["pooling_type"] != "probabilistic" or model.get("n_kernels", 1) != 1
                or model["hidden_bias_type"] != "shared" or model.get("num_label_nodes", 1) != 1
                or model.get("learn_penalty") or model.get("center_fmap")
                or not model["sequential_layer_sizes"]):
            raise ValueError("the reference takes probabilistic pooling, one kernel, a "
                             "shared conv bias, sequential layers and one label unit")
        return cls(tuple(model["image_shape"]), model["kernel_size"], model["stride"],
                   model["pooling_size"], tuple(model["sequential_layer_sizes"]))

    @property
    def grid(self):
        return tuple((d - self.k) // self.stride + 1 for d in self.image)

    @property
    def conv(self) -> int:
        return self.grid[0] * self.grid[1]

    def windows(self) -> np.ndarray:
        oh, ow = self.grid
        p = self.pool
        return np.asarray([[(i + a) * ow + (j + b) for a in range(p) for b in range(p)]
                           for i in range(0, oh - p + 1, p) for j in range(0, ow - p + 1, p)])

    @property
    def n_windows(self) -> int:
        return len(self.windows())

    def seq_starts(self) -> list[int]:
        starts, cur = [], self.conv + self.n_windows
        for size in self.seq:
            starts.append(cur)
            cur += size
        return starts

    @property
    def hidden(self) -> int:
        return self.conv + self.n_windows + sum(self.seq)

    def patches(self, x_img: torch.Tensor) -> torch.Tensor:
        """(B, conv, k, k) patches of images (B, H, W)."""
        oh, ow = self.grid
        s, k = self.stride, self.k
        rows = (torch.arange(oh) * s)[:, None, None, None] + torch.arange(k)[None, None, :, None]
        cols = (torch.arange(ow) * s)[None, :, None, None] + torch.arange(k)[None, None, None, :]
        idx = (rows * self.image[1] + cols).reshape(oh * ow, k, k).to(x_img.device)
        return x_img.reshape(x_img.shape[0], -1)[:, idx]


def leaf_specs(model: dict) -> list[tuple]:
    g = Layout.of(model)
    specs = [("kernel", (1, g.k, g.k), "uniform")]
    prev = g.n_windows
    for i, size in enumerate(g.seq):
        specs.append((f"w_seq.{i}", (prev, size), "uniform"))
        specs.append((f"w_seq_intra.{i}", (size, size),
                      "zeros" if model["is_restricted"] else "upper"))
        prev = size
    return specs + [("w_h2o", (prev, 1), "uniform"), ("w_oo", (1, 1), "upper"),
                    ("b_conv", (1,), "uniform"), ("b_seq", (sum(g.seq),), "uniform"),
                    ("b_o", (1,), "uniform")]


def free_units(model: dict) -> dict:
    n = Layout.of(model).hidden
    return {"clamped": n, "unclamped": n + 1}


def _penalty(g: Layout, c: float, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The pooling penalty's linear terms (hidden,) and couplings."""
    lin = np.zeros(g.hidden, np.float32)
    U = np.zeros((g.hidden, g.hidden), np.float32)
    for w, ids in enumerate(g.windows()):
        pv = g.conv + w
        for a in range(len(ids)):
            U[ids[a], ids[a + 1:]] = c
        U[ids, pv] = -2.0 * c
        lin[ids] = c
        lin[pv] = c
    return torch.as_tensor(lin, device=device), torch.as_tensor(U, device=device)


def _hidden(p: dict, x_img, model: dict, prec: Precision):
    """Linear terms (S, B, hidden) and couplings (S, hidden, hidden) of the
    hidden units, before β_eff."""
    g = Layout.of(model)
    S = p["kernel"].shape[0]
    lin, U0 = _penalty(g, model["prob_penalty"], x_img.device)
    fmap = prec.einsum("bukl,skl->sbu", g.patches(x_img), p["kernel"][:, 0])
    h = lin.expand(S, x_img.shape[0], -1).clone()
    h[..., :g.conv] += fmap + p["b_conv"][:, None, :1]
    U = U0.expand(S, -1, -1).clone()
    prev = slice(g.conv, g.conv + g.n_windows)
    for i, (start, size) in enumerate(zip(g.seq_starts(), g.seq)):
        cur = slice(start, start + size)
        U[:, prev, cur] += p[f"w_seq.{i}"]
        if not model["is_restricted"]:
            U[:, cur, cur] += torch.triu(p[f"w_seq_intra.{i}"], 1)
        prev = cur
    first = g.seq_starts()[0]
    h[..., first:first + sum(g.seq)] += p["b_seq"][:, None, :]
    return h, U, prev


def _unclamped(p, x_img, model, prec):
    h_h, U_h, last = _hidden(p, x_img, model, prec)
    S, B, n = h_h.shape
    h = torch.cat([h_h, p["b_o"][:, None, :].expand(S, B, 1)], dim=-1)
    U = torch.zeros((S, n + 1, n + 1), device=h.device)
    U[:, :n, :n] = U_h
    U[:, last, n:] += p["w_h2o"]
    return h / model["beta_eff"], U / model["beta_eff"]


def step_problems(p: dict, x_img, y, model: dict, prec: Precision = FP32) -> dict:
    """The step's QUBOs a phase: ``{phase: (h (S, B, n), U (S, n, n))}``."""
    h, U, last = _hidden(p, x_img, model, prec)
    h[..., last] += prec.matmul(y.to(torch.float32)[:, None], p["w_h2o"].transpose(-1, -2))
    beta = model["beta_eff"]
    return {"clamped": (h / beta, U / beta), "unclamped": _unclamped(p, x_img, model, prec)}


def predict_problems(p: dict, x_img, model: dict, prec: Precision = FP32):
    return _unclamped(p, x_img, model, prec)


def _moments(s, patches, model: dict, label, prec: Precision) -> dict:
    """Per-example statistics (S, B, ...) of samples ``s`` (S, B, R, ·)."""
    g = Layout.of(model)
    R = s.shape[2]
    E = s.mean(2)
    Econv = E[..., :g.conv]
    out = {"kernel": prec.einsum("bukl,sbu->sbkl", patches, Econv)[:, :, None],
           "b_conv": Econv.sum(-1, keepdim=True)}
    prev = slice(g.conv, g.conv + g.n_windows)
    for i, (start, size) in enumerate(zip(g.seq_starts(), g.seq)):
        cur = slice(start, start + size)
        out[f"w_seq.{i}"] = prec.einsum("sbri,sbrj->sbij", s[..., prev], s[..., cur]) / R
        out[f"w_seq_intra.{i}"] = torch.triu(
            prec.einsum("sbri,sbrj->sbij", s[..., cur], s[..., cur]) / R, 1)
        prev = cur
    first = g.seq_starts()[0]
    out["b_seq"] = E[..., first:first + sum(g.seq)]
    if label is None:
        ys = s[..., g.hidden:]
        out["w_h2o"] = prec.einsum("sbri,sbrj->sbij", s[..., prev], ys) / R
        out["b_o"] = ys.mean(2)
        out["w_oo"] = torch.triu(prec.einsum("sbri,sbrj->sbij", ys, ys) / R, 1)
    else:
        S = s.shape[0]
        out["w_h2o"] = E[..., prev][..., :, None] * label[None, :, None, :]
        out["b_o"] = label.expand(S, -1, -1)
        out["w_oo"] = torch.triu(label[:, :, None] * label[:, None, :], 1).expand(S, -1, -1, -1)
    return out


def probs(s_u: torch.Tensor, model: dict) -> torch.Tensor:
    n = Layout.of(model).hidden
    p1 = s_u[..., n].mean(2).clamp(1e-12, 1 - 1e-12)
    return torch.stack([1.0 - p1, p1], dim=-1)


def update(p: dict, x_img, y, mask, lr: float, s_c, s_u, model: dict,
           prec: Precision = FP32):
    """One step from the samples of its two phases: ``(grad, new params,
    nll (S,))``."""
    patches = Layout.of(model).patches(x_img)
    label = y.to(torch.float32)[:, None]
    mc = _moments(s_c, patches, model, label, prec)
    mu = _moments(s_u, patches, model, None, prec)
    denom = mask.sum().clamp_min(1.0)
    grad = {}
    for k in p:
        d = mc[k] - mu[k]
        grad[k] = (d * mask.reshape((1, -1) + (1,) * (d.dim() - 2))).sum(1) / denom
        if k.startswith("w_seq_intra") and model["is_restricted"]:
            grad[k] = torch.zeros_like(grad[k])
    new = {k: p[k] - lr * grad[k] for k in p}
    pr = probs(s_u, model)
    pick = torch.gather(pr, 2, y.long()[None, :, None].expand(pr.shape[0], -1, 1))[..., 0]
    nll = (-torch.log(pick + 1e-12) * mask).sum(1) / denom
    return grad, new, nll


def predictions(s_u: torch.Tensor, model: dict):
    """``(predictions (S, N), probabilities (S, N, 2))``: the likelier class,
    the first on a tie."""
    pr = probs(s_u, model)
    return torch.argmax(pr, dim=-1), pr
