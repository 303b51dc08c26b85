"""The threefry2x32 counter-based generator in numpy: the key, ``split`` and
float32 ``uniform`` draws of ``jax.random`` under its default
implementation (threefry2x32 with partitionable counters).

The flat Disc_QBM and the CDQBM (single models and seed sweeps) draw
their initial parameters here, from the very keys ``qbmx`` draws them from
for the same seed and attempt (:func:`init_key`), so that a seed starts
where ``qbmx``'s does and the two packages' runs differ only in the
samplers' draws, which come from ``torch.Generator`` streams
(``core/rng.py``).  A keyed stream of 32-bit words is all that needs, and
this module is it, in numpy, with no import of jax."""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The 20-round Threefry-2x32 block function of ``key`` (2,) uint32 on
    the counter words ``x0``, ``x1`` (uint32 arrays of one shape)."""
    ks = (key[0], key[1], key[0] ^ key[1] ^ _PARITY)
    with np.errstate(over="ignore"):
        x0, x1 = x0 + ks[0], x1 + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def key(seed: int) -> np.ndarray:
    """The key of a seed in [0, 2³²): the words (0, seed).  (Wider seeds
    are refused: 32-bit jax truncates them, 64-bit jax keeps the high word.)"""
    seed = int(seed)
    if not 0 <= seed < 2**32:
        raise ValueError(f"seed {seed} is not in [0, 2**32)")
    return np.array([0, seed], dtype=np.uint32)


def _counters(count: int) -> tuple[np.ndarray, np.ndarray]:
    """The (high, low) words of the flat indices 0 .. count - 1."""
    idx = np.arange(count, dtype=np.uint64)
    return (idx >> np.uint64(32)).astype(np.uint32), (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def split(k: np.ndarray, num: int = 2) -> np.ndarray:
    """``num`` new keys, (num, 2) uint32: the block function of ``k`` on the
    counters 0 .. num - 1."""
    b0, b1 = threefry2x32(k, *_counters(num))
    return np.stack([b0, b1], axis=-1)


def fold_in(k: np.ndarray, data: int) -> np.ndarray:
    """The key ``jax.random.fold_in(k, data)``: the block function of ``k``
    on the counter words (0, data), for ``data`` in [0, 2³²)."""
    b0, b1 = threefry2x32(k, np.zeros(1, np.uint32), np.array([data], dtype=np.uint32))
    return np.array([b0[0], b1[0]], dtype=np.uint32)


def init_key(seed: int, attempt: int = 0) -> np.ndarray:
    """The key ``qbmx``'s models and sweeps draw a seed's initial
    parameters from: ``split(key(seed))[1]``, and for a re-draw
    ``split(fold_in(key(seed), attempt))[1]``."""
    k = key(seed)
    return split(fold_in(k, attempt) if attempt else k)[1]


def uniform(k: np.ndarray, shape, minval: float = 0.0, maxval: float = 1.0) -> np.ndarray:
    """float32 draws in [minval, maxval) of ``shape``: 32 random bits an
    entry (the two words of the block on its flat index, xor-ed), the top
    23 as the mantissa of a float in [1, 2), minus 1, scaled and shifted in
    float32."""
    shape = tuple(int(d) for d in shape)
    b0, b1 = threefry2x32(k, *_counters(int(np.prod(shape, dtype=np.int64))))
    bits = (b0 ^ b1) >> np.uint32(32 - 23) | np.float32(1.0).view(np.uint32)
    floats = bits.view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, floats * (hi - lo) + lo).reshape(shape)
