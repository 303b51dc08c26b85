"""Static geometry for the convolutional-deep QBM — a copy of
``qbmx.models.geometry`` (numpy only; the port never imports ``qbmx``, and
``tests/test_torch_cdqbm.py`` holds the two equal).

Everything here is computed once at model-construction time and is pure
Python/numpy over *static* configuration — shapes never depend on data.
Mirrors the capability of the reference ``src/model/geometry.py`` and
``src/model/layers.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def conv_output_shape(image_shape, kernel_size: int, stride: int):
    """Valid-mode conv output dims (reference ``conv_output_shape``,
    ``src/model/geometry.py:7-17``)."""
    H, W = image_shape
    return ((H - kernel_size) // stride + 1, (W - kernel_size) // stride + 1)


def patch_index_grid(image_shape, kernel_size: int, stride: int) -> np.ndarray:
    """(num_conv_units, k, k) flat-pixel indices of each conv unit's patch —
    the gather table replacing the reference's per-unit (rows, cols)
    coordinate lists (``get_input_groups_coords``, ``src/model/geometry.py:20-34``)."""
    H, W = image_shape
    k, s = kernel_size, stride
    oh, ow = conv_output_shape(image_shape, k, s)
    ii = np.arange(oh) * s
    jj = np.arange(ow) * s
    di, dj = np.meshgrid(np.arange(k), np.arange(k), indexing="ij")
    # (oh, ow, k, k) absolute pixel coordinates
    rows = ii[:, None, None, None] + di[None, None]
    cols = jj[None, :, None, None] + dj[None, None]
    flat = rows * W + cols
    return flat.reshape(oh * ow, k, k)


def build_pool_windows(conv_dim, pool_size: int) -> np.ndarray:
    """Non-overlapping p×p windows over the flattened conv fmap as an
    (n_windows, p*p) index array (reference ``build_pool_windows``,
    ``src/model/geometry.py:56-77``; returns an empty (0, 0) array when
    pooling is disabled)."""
    if pool_size in (0, 1):
        return np.zeros((0, 0), dtype=np.int64)
    H, W = conv_dim
    p = pool_size
    wins = []
    for i in range(0, H - p + 1, p):
        for j in range(0, W - p + 1, p):
            idxs = [(i + di) * W + (j + dj) for di in range(p) for dj in range(p)]
            wins.append(idxs)
    return np.asarray(wins, dtype=np.int64)


@dataclasses.dataclass(frozen=True)
class StackGeometry:
    """All static structure of a CDQBM stack: unit counts and block offsets.

    Variable layout of the QUBO (matching the reference's modular slices,
    ``src/model/layers.py:29-58``):

        [conv block][pool vars (probabilistic only)][seq layer 0]...[out]

    For deterministic pooling the conv block holds only the per-window
    argmin units (``conv_active == n_windows``); for probabilistic pooling
    all conv units are present plus one dedicated pool variable per window.
    """

    image_shape: tuple[int, int]
    kernel_size: int
    stride: int
    pooling_size: int
    pooling_type: str  # "deterministic" | "probabilistic"
    seq_sizes: tuple[int, ...]
    n_out: int
    #: conv CHANNELS (flag-gated ``--n_kernels`` extension, VERDICT r4 #2).
    #: The reference has exactly one shared k×k kernel
    #: (``src/model/cdqbm.py:289-381``); n_kernels=1 keeps every count,
    #: slice, and QUBO bit-identical to that.  C>1 stacks C channel copies
    #: of the conv(+pool) block channel-major ahead of the sequential
    #: layers: each channel gets its own feature map and pooling windows.
    n_kernels: int = 1

    def __post_init__(self):
        if self.pooling_type not in ("deterministic", "probabilistic"):
            raise ValueError(f"Unknown pooling_type: {self.pooling_type}")
        if self.n_kernels < 1:
            raise ValueError(f"n_kernels must be >= 1, got {self.n_kernels}")

    @property
    def conv_dim(self):
        return conv_output_shape(self.image_shape, self.kernel_size, self.stride)

    @property
    def num_conv_units(self) -> int:
        """Conv units PER CHANNEL (the patch-grid size)."""
        oh, ow = self.conv_dim
        return oh * ow

    @property
    def conv_units_total(self) -> int:
        """Conv units across all channels (the conv block's variable count
        for probabilistic pooling / no pooling)."""
        return self.n_kernels * self.num_conv_units

    @property
    def pool_windows(self) -> np.ndarray:
        """(n_windows, p*p) indices into the CHANNEL-MAJOR conv block:
        channel c's windows are the base single-channel windows offset by
        ``c * num_conv_units``."""
        base = build_pool_windows(self.conv_dim, self.pooling_size)
        if base.shape[0] == 0 or self.n_kernels == 1:
            return base
        return np.concatenate(
            [base + c * self.num_conv_units for c in range(self.n_kernels)], axis=0)

    @property
    def n_windows(self) -> int:
        return self.pool_windows.shape[0]

    @property
    def has_pooling(self) -> bool:
        return self.n_windows > 0

    @property
    def conv_active(self) -> int:
        if self.pooling_type == "deterministic":
            return self.n_windows if self.has_pooling else self.conv_units_total
        return self.conv_units_total

    @property
    def n_pooled(self) -> int:
        """Units feeding the first sequential layer (reference
        ``count_pooled_units``, ``src/model/geometry.py:86-92``)."""
        return self.n_windows if self.has_pooling else self.conv_units_total

    @property
    def n_pool_vars(self) -> int:
        return self.n_windows if (self.pooling_type == "probabilistic" and self.has_pooling) else 0

    @property
    def n_hidden(self) -> int:
        return self.conv_active + self.n_pool_vars + sum(self.seq_sizes)

    @property
    def n_total(self) -> int:
        return self.n_hidden + self.n_out

    # -- block slices (static) ----------------------------------------------

    @property
    def conv_slice(self) -> slice:
        return slice(0, self.conv_active)

    @property
    def pool_slice(self) -> slice:
        """Block feeding the first sequential layer: dedicated pool vars for
        probabilistic pooling, the conv block itself otherwise."""
        if self.n_pool_vars:
            return slice(self.conv_active, self.conv_active + self.n_pool_vars)
        return self.conv_slice

    @property
    def seq_slices(self) -> tuple[slice, ...]:
        cur = self.conv_active + self.n_pool_vars
        out = []
        for s in self.seq_sizes:
            out.append(slice(cur, cur + s))
            cur += s
        return tuple(out)

    @property
    def out_slice(self) -> slice:
        return slice(self.n_hidden, self.n_total)

    @property
    def last_hidden_slice(self) -> slice:
        """Block wired to the output nodes (reference ``last_hidden_slice``,
        ``src/model/layers.py:60-61``)."""
        if self.seq_sizes:
            return self.seq_slices[-1]
        return self.pool_slice if self.n_pool_vars else self.conv_slice

    @property
    def last_hidden_size(self) -> int:
        sl = self.last_hidden_slice
        return sl.stop - sl.start

    # -- stats layout: columns of the per-phase "stats matrix" ---------------
    # For probabilistic pooling the reference drops the conv columns before
    # computing layer statistics (``src/train/train.py:157-161``): the
    # pooled block is then the pool vars. sizes_active = [n_pooled, *seq].

    @property
    def stats_drop(self) -> int:
        """Leading sample columns dropped before layer statistics."""
        return self.conv_units_total if self.n_pool_vars else 0

    @property
    def sizes_active(self) -> tuple[int, ...]:
        return (self.n_pooled,) + tuple(self.seq_sizes)

    @property
    def stats_starts(self) -> tuple[int, ...]:
        starts, cur = [], 0
        for s in self.sizes_active:
            starts.append(cur)
            cur += s
        return tuple(starts)

    @property
    def n_stats_hidden(self) -> int:
        return sum(self.sizes_active)
