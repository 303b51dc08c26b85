"""Coreset selection: k-center-greedy subsampling — counterpart of
``qbmx.data.coreset`` (reference ``src/coreset.py``: ``k_center_greedy``
``:28-106``, ``downsample_kcenter_with_light_model`` ``:109-121``,
``random_downsampling`` ``:123-140``).

The greedy max-min loop keeps an O(N) running minimum distance on the
embedding's device, as ``qbmx``'s ``lax.fori_loop`` does, instead of the
reference's O(budget × N) distance rows.
"""

from __future__ import annotations

import numpy as np
import torch


def _k_center_greedy(emb: torch.Tensor, num_new: int, seeds: list[int]) -> list[int]:
    """``num_new`` NEW row indices of ``emb``, maximally spread relative to
    the ``seeds`` centers and to each other."""
    sq = torch.sum(emb * emb, dim=1)

    def dist_to(idx: int) -> torch.Tensor:
        c = emb[idx]
        d2 = sq + torch.dot(c, c) - 2.0 * (emb @ c)
        return torch.sqrt(torch.clamp(d2, min=1e-12))

    mins = torch.full((emb.shape[0],), float("inf"), dtype=torch.float32, device=emb.device)
    for s in seeds:
        mins = torch.minimum(mins, dist_to(s))
        mins[s] = -float("inf")
    selected = []
    for _ in range(num_new):
        p = int(torch.argmax(mins))
        selected.append(p)
        mins = torch.minimum(mins, dist_to(p))
        mins[p] = -float("inf")
    return selected


def k_center_greedy(embedding_matrix, budget: int, random_seed=None, index=None,
                    already_selected=None):
    """Greedy k-center selection over row embeddings.

    Returns exactly ``min(budget, n)`` sorted indices (through ``index`` if
    given), ``qbmx``'s contract: ALL ``already_selected`` entries count as
    centers (distance-initialized and included in the result); if they
    already meet the budget they are returned as they are.  Without them
    the first center is ``numpy.random.default_rng(random_seed)``'s draw."""
    emb = torch.as_tensor(np.asarray(embedding_matrix, dtype=np.float32))
    n = emb.shape[0]
    budget = min(budget, n)
    if index is not None:
        index = np.asarray(index)
        if len(index) != n:
            raise ValueError(f"index has {len(index)} entries for {n} embeddings")
    else:
        index = np.arange(n)
    rng = np.random.default_rng(random_seed)
    if already_selected:
        seeds = sorted({int(s) for s in already_selected})
    else:
        seeds = [int(rng.integers(0, n))]
    num_new = budget - len(seeds)
    if num_new <= 0:
        return index[np.asarray(seeds)]
    sel = _k_center_greedy(emb, num_new, seeds)
    return index[np.unique(np.concatenate([np.asarray(seeds), np.asarray(sel)]))]


def downsample_kcenter_with_light_model(qbm, train_x, train_y, budget: int, random_seed: int):
    """Select a coreset in the model's last-hidden embedding space
    (reference ``src/coreset.py:109-121``)."""
    emb = qbm.get_last_hidden_embedding(train_x)
    idx = k_center_greedy(emb, budget=budget, random_seed=random_seed)
    return np.asarray(train_x)[idx], np.asarray(train_y)[idx]


def random_downsampling(x, y, downsample_size: int, seed: int = 42):
    if len(x) < downsample_size:
        raise ValueError(
            "Downsample size must be less than the number of samples in the dataset."
        )
    rng = np.random.default_rng(seed)
    idx = rng.choice(len(x), downsample_size, replace=False)
    return np.asarray(x)[idx], np.asarray(y)[idx]
