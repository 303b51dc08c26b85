"""Random-number plumbing: explicit ``torch.Generator``s in place of
``jax.random`` keys."""

from __future__ import annotations

import numpy as np
import torch


def make_generator(seed: int, attempt: int = 0) -> torch.Generator:
    """A CPU generator whose stream is a pure function of ``(seed,
    attempt)`` — the counterpart of ``fold_in(key(seed), attempt)``."""
    state = np.random.SeedSequence([int(seed), int(attempt)]).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(state[0]))


def rand(shape, generator: torch.Generator | None = None, device="cpu") -> torch.Tensor:
    """U[0, 1) float32 of ``shape`` on ``device``, drawn on the generator's
    own device (and moved when the two differ)."""
    src = generator.device if generator is not None else torch.device(device)
    return torch.rand(shape, generator=generator, device=src).to(device)


def draw_seed(generator: torch.Generator | None = None) -> int:
    """A 63-bit seed drawn from ``generator`` (the default CPU generator
    when ``None``) — keys a kernel's counter-based Philox streams."""
    src = generator.device if generator is not None else "cpu"
    return int(torch.randint(0, 2**63 - 1, (1,), generator=generator, device=src))


def draw_seeds(generator: torch.Generator | None, count: int) -> np.ndarray:
    """``count`` 63-bit seeds as a (count,) uint64 array, drawn from
    ``generator`` in one call — one a problem for the host samplers."""
    src = generator.device if generator is not None else "cpu"
    seeds = torch.randint(0, 2**63 - 1, (count,), generator=generator, device=src)
    return seeds.cpu().numpy().astype(np.uint64)
