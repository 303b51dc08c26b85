"""Random-number plumbing: explicit ``torch.Generator``s in place of
``jax.random`` keys.

Every draw of the samplers' plain versions, the kernels' launch seeds and
the RBM's chain draws goes through :func:`rand`, :func:`draw_seed` and
:func:`draw_seeds`, which also take a :class:`RowStream`: a rank's window
onto the draws of a call it runs only some groups of (the seed-sharded
sweeps, ``train/sweep.py``)."""

from __future__ import annotations

import numpy as np
import torch


def make_generator(seed: int, attempt: int = 0) -> torch.Generator:
    """A CPU generator whose stream is a pure function of ``(seed,
    attempt)`` — the counterpart of ``fold_in(key(seed), attempt)``."""
    state = np.random.SeedSequence([int(seed), int(attempt)]).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(state[0]))


def fold_in(generator: torch.Generator, *data: int) -> torch.Generator:
    """A CPU generator whose stream is a pure function of one seed drawn
    from ``generator`` and of ``data`` — the counterpart of
    ``fold_in(fold_in(key, d0), d1)``.  Every caller that folds the same
    generator in the same state leaves it in the same state."""
    seed = draw_seed(generator)
    state = np.random.SeedSequence([seed, *map(int, data)]).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(state[0]))


class RowStream:
    """Rows ``rows`` of the draws a generator would give a call over
    ``total`` groups.

    A draw whose leading axis holds ``k`` entries a group (``len(rows)·k``
    in all: the groups, or their problems) is drawn for all ``total·k``
    entries from ``generator`` and the entries of ``rows`` are kept, so
    the rows get exactly the numbers the whole call would give them and
    every holder of the stream leaves ``generator`` in the same state.

    A kernel's launch seed (:meth:`seed`) cannot be taken by rows: the
    kernels key Philox by ``(seed, the problem's index within the
    launch)``, and every holder launches the same local indices.  So the
    seed drawn from ``generator`` is folded with the stream's first row,
    unless the stream holds the whole call: holders of other rows anneal
    from other numbers, and agree with the whole call statistically, not
    bit for bit."""

    def __init__(self, generator: torch.Generator, rows, total: int):
        self.generator = generator
        self.rows = torch.as_tensor(list(rows), dtype=torch.int64)
        self.total = int(total)
        self.device = generator.device
        self.whole = self.rows.tolist() == list(range(self.total))

    def _index(self, lead: int) -> tuple[torch.Tensor, int]:
        k, rest = divmod(lead, len(self.rows))
        if rest or k == 0:
            raise ValueError(f"a draw of leading size {lead} does not split into the "
                             f"{len(self.rows)} rows of this stream")
        return (self.rows[:, None] * k + torch.arange(k)).reshape(-1), self.total * k

    def rand(self, shape, device) -> torch.Tensor:
        idx, full = self._index(shape[0])
        return rand((full,) + tuple(shape[1:]), self.generator, device)[idx.to(device)]

    def seeds(self, count: int) -> np.ndarray:
        idx, full = self._index(count)
        return draw_seeds(self.generator, full)[idx.numpy()]

    def seed(self) -> int:
        seed = draw_seed(self.generator)
        if self.whole:
            return seed
        state = np.random.SeedSequence([seed, int(self.rows[0])]).generate_state(1, np.uint64)
        return int(state[0]) >> 1  # 63 bits, as draw_seed's


def rand(shape, generator: torch.Generator | RowStream | None = None,
         device="cpu") -> torch.Tensor:
    """U[0, 1) float32 of ``shape`` on ``device``, drawn on the generator's
    own device (and moved when the two differ)."""
    if isinstance(generator, RowStream):
        return generator.rand(tuple(shape), device)
    src = generator.device if generator is not None else torch.device(device)
    return torch.rand(shape, generator=generator, device=src).to(device)


def draw_seed(generator: torch.Generator | RowStream | None = None) -> int:
    """A 63-bit seed drawn from ``generator`` (the default CPU generator
    when ``None``) — keys a kernel's counter-based Philox streams."""
    if isinstance(generator, RowStream):
        return generator.seed()
    src = generator.device if generator is not None else "cpu"
    return int(torch.randint(0, 2**63 - 1, (1,), generator=generator, device=src))


def draw_seeds(generator: torch.Generator | RowStream | None, count: int) -> np.ndarray:
    """``count`` 63-bit seeds as a (count,) uint64 array, drawn from
    ``generator`` in one call — one a problem for the host samplers."""
    if isinstance(generator, RowStream):
        return generator.seeds(count)
    src = generator.device if generator is not None else "cpu"
    seeds = torch.randint(0, 2**63 - 1, (count,), generator=generator, device=src)
    return seeds.cpu().numpy().astype(np.uint64)
