"""The launch-geometry rules of the anneal kernels, on the CPU: K1's layout
choice (``sa_cuda.k1_layout``: one thread per chain, or a chain spread over
a warp) and K4's geometry (``wide_cuda.wide_geometry``: chains per block, a
warp each, and shared memory) at the shapes the main paths launch, at the
K1/K4 boundary and at K4's widest n; K4's field-drift limit and the
roofline bound.  ``test_torch_cuda.py`` checks on the card that the kernels
accept what these rules report."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from qbmx_torch.core.qubo import random_qubo_batch, split_qubo
from qbmx_torch.samplers import kernel_call, sa_cuda, wide_cuda
from qbmx_torch.utils import roofline

GRID_X, GRID_Y = 2**31 - 1, 65535
SHAPES = {  # (G, B, R, n) of the calls the main paths make
    "flagship": (2, 60, 1000, 6),
    "flat CLI defaults": (2, 73, 100, 3),
    "dense bench": (60, 1, 100, 41),
    "CDQBM (b)": (2, 3, 100, 41),
    "CDQBM (b) prediction": (1, 32, 100, 41),
    "CDQBM (a)": (2, 20, 100, 717),
    "CDQBM (a) prediction": (1, 32, 100, 717),
    "n=241": (2, 3, 100, 241),
    "n=241 many chains": (2, 3, 10000, 241),
    "n=242": (2, 3, 100, 242),
}


def _within_limits(smem: int, threads: int, grid: tuple) -> None:
    assert 0 < smem <= kernel_call.SMEM_BYTES == 232_448
    assert 0 < threads <= 1024 and threads % 8 == 0
    assert 1 <= grid[0] <= GRID_X and 1 <= grid[1] <= GRID_Y


@pytest.mark.parametrize("name", [k for k, v in SHAPES.items() if v[3] <= 241])
def test_k1_layout_within_the_card_limits(name):
    G, B, R, n = SHAPES[name]
    lay = sa_cuda.k1_layout(G, B, R, n)
    _within_limits(lay.smem, sa_cuda.THREADS, lay.grid)
    assert lay.smem == 4 * n * n
    assert lay.chains_per_block * lay.lanes == sa_cuda.THREADS
    assert lay.grid == (math.ceil(B * R / lay.chains_per_block), G)
    assert lay.grid[0] * lay.chains_per_block >= B * R  # every chain has a place
    if lay.lanes > 1:
        assert lay.slots * lay.lanes >= n and lay.slots & (lay.slots - 1) == 0
        assert lay.slots <= 8  # the kernel's slot buckets


@pytest.mark.parametrize("name,lanes", [
    ("flagship", 1),  # 120,000 chains at n = 6: a thread a chain
    ("flat CLI defaults", 1),  # 14,600 chains at n = 3
    ("dense bench", 32),  # 6,000 chains at n = 41: too wide for THREAD
    ("CDQBM (b)", 32),  # 600 chains: a warp a chain
    ("CDQBM (b) prediction", 32),  # 3,200 chains
    ("n=241", 32),
    ("n=241 many chains", 32),  # 60,000 chains
])
def test_k1_layout_chosen(name, lanes):
    assert sa_cuda.k1_layout(*SHAPES[name]).lanes == lanes


def test_k1_layout_boundaries():
    few = 32 * kernel_call.NUM_SMS  # 4,224 chains
    assert sa_cuda.k1_layout(1, 1, few, 8).lanes == 32
    assert sa_cuda.k1_layout(1, 1, few + 1, 8).lanes == 1
    assert sa_cuda.k1_layout(1, 1, few + 1, 9).lanes == 32
    assert sa_cuda.k1_layout(1, 1, few, 9).lanes == 32
    # a forced layout, as the checks of each layout ask for it
    assert sa_cuda.k1_layout(1, 1, 512, 5, lanes=1).lanes == 1
    assert sa_cuda.k1_layout(2, 60, 1000, 6, lanes=32).slots == 1
    assert sa_cuda.k1_layout(1, 1, 8, 128, lanes=32).slots == 4
    assert sa_cuda.k1_layout(1, 1, 8, 241, lanes=32).slots == 8
    with pytest.raises(ValueError, match="no layout"):
        sa_cuda.k1_layout(1, 1, 8, 41, lanes=8)
    with pytest.raises(ValueError, match="no layout"):
        sa_cuda.k1_layout(1, 1, 8, 9, lanes=1)
    with pytest.raises(ValueError, match="no layout"):
        sa_cuda.k1_layout(1, 1, 8, 9, lanes=16)
    with pytest.raises(ValueError, match="exceeds its bound"):
        sa_cuda.k1_layout(1, 1, 8, 242)


@pytest.mark.parametrize("name", [k for k, v in SHAPES.items() if v[3] > 241])
def test_wide_geometry_within_the_card_limits(name):
    G, B, R, n = SHAPES[name]
    geo = wide_cuda.wide_geometry(G, B, R, n)
    _within_limits(geo.smem, geo.threads, geo.grid)
    assert geo.threads == wide_cuda.LANES * geo.chains_per_block <= 1024
    assert geo.smem == wide_cuda.smem_bytes(n, geo.chains_per_block)
    assert geo.grid == (math.ceil(B * R / geo.chains_per_block), G)


def test_wide_geometry_at_the_cdqbm_shapes():
    """CDQBM (a): 4,000 chains, a warp each, 31 a block: 130 blocks (one
    per SM) of 31 warps; its prediction chunk 3,200 chains, 25 a block."""
    geo = wide_cuda.wide_geometry(*SHAPES["CDQBM (a)"])
    assert (geo.chains_per_block, geo.threads, geo.grid) == (31, 992, (65, 2))
    assert geo.grid[0] * geo.grid[1] <= kernel_call.NUM_SMS
    assert geo.smem == 4 * (16 * 720 + 31 * (720 + 180))
    geo = wide_cuda.wide_geometry(*SHAPES["CDQBM (a) prediction"])
    assert (geo.chains_per_block, geo.grid) == (25, (128, 1))
    geo = wide_cuda.wide_geometry(2, 60, 100, 717)  # 12,000 chains: 32 a block
    assert (geo.chains_per_block, geo.threads) == (32, 1024)


def test_wide_max_n_is_the_widest_geometry():
    """Every width K4 took before (n ≤ 2400) stays covered; at the widest n
    one chain a block still fits, and one more variable does not."""
    top = wide_cuda.max_n()
    assert top >= 2400
    assert wide_cuda.smem_bytes(top, 1) <= kernel_call.SMEM_BYTES < wide_cuda.smem_bytes(top + 1, 1)
    for n in (2400, top):
        geo = wide_cuda.wide_geometry(2, 20, 100, n)
        _within_limits(geo.smem, geo.threads, geo.grid)
    assert wide_cuda.wide_geometry(2, 20, 100, top).chains_per_block == 1
    with pytest.raises(ValueError, match="exceeds its bound"):
        wide_cuda.wide_geometry(2, 20, 100, top + 1)


@pytest.mark.parametrize("n,jrow,frow", [(242, 244, 248), (717, 720, 720), (2400, 2400, 2400)])
def test_wide_layout_strides(n, jrow, frow):
    """J's rows padded to 16 bytes; each chain's fields and state bytes
    cover whole tiles of 8 variables, so the last tile's whole-tile reads
    stay inside the chain's rows."""
    assert wide_cuda.row_floats(n) == jrow and jrow % 4 == 0 and jrow - n < 4
    assert frow % 8 == 0 and 0 <= frow - n < 8
    assert wide_cuda.smem_bytes(n, 1) == 4 * (16 * jrow + frow + frow // 4)
    assert wide_cuda.smem_bytes(n, 3) - wide_cuda.smem_bytes(n, 2) == 4 * (frow + frow // 4)


def test_k1_k4_boundary():
    """K1 (J_g in shared memory) up to n = 241, K4 above."""
    assert kernel_call.fits_shared(241) and not kernel_call.fits_shared(242)
    assert sa_cuda.k1_layout(2, 3, 100, 241).smem <= kernel_call.SMEM_BYTES
    assert wide_cuda.wide_geometry(2, 3, 100, 242).threads == 32 * 5  # 600 chains, 5 a block


def test_optional_outputs_are_checked():
    """The kernels' optional outputs (flips, fields_out) are refused unless
    they have the shape, dtype and device the kernel writes."""
    import torch

    cpu = torch.device("cpu")
    assert kernel_call.optional_ptr(None, "flips", (1,), torch.int64, cpu) is None
    flips = torch.zeros(1, dtype=torch.int64)
    assert kernel_call.optional_ptr(flips, "flips", (1,), torch.int64, cpu) == flips.data_ptr()
    with pytest.raises(ValueError, match="flips: need a contiguous int64"):
        kernel_call.optional_ptr(torch.zeros(1), "flips", (1,), torch.int64, cpu)
    with pytest.raises(ValueError, match="fields_out"):
        kernel_call.optional_ptr(torch.zeros((2, 3)).T, "fields_out", (3, 2), torch.float32, cpu)


@pytest.mark.parametrize("n,S", [(300, 100), (717, 1000)])
def test_field_drift_limit_catches_one_lost_add(n, S):
    """K4's drift limit lies below every row's median |J_jk|, so a field
    one add short (or over) fails it, at the CDQBM (a) depth too; and it
    grows as the square root of the adds since the last refresh."""
    rng = np.random.default_rng(n)
    hs, J = split_qubo(random_qubo_batch(rng, 1, n))
    h = hs[:, None, :] + torch.as_tensor(rng.normal(size=(1, 2, n)).astype(np.float32))
    bound = wide_cuda.field_drift_bound(h, J, S)
    assert bound.shape == (1, 2, 1, n) and bound.dtype == torch.float64
    typical = J[0].abs().masked_fill(J[0] == 0, float("nan")).nanmedian(dim=1).values
    assert (bound[0, :, 0] < typical.double()).all()
    since = S - wide_cuda.REFRESH_PERIOD * ((S - 1) // wide_cuda.REFRESH_PERIOD)
    scale = h.double().abs() + J.double().abs().sum(-1)[:, None, :]
    assert torch.allclose(bound[:, :, 0], math.sqrt(n + 1 + n * since) * 2.0**-24 * scale)


def test_roofline_bound_counts_issue_slots():
    """An FMA is one of the 33.5e12 instructions a second (two of the 67e12
    flops); the Philox draws' int32 multiplies are bounded at half that
    rate; a launch that moves more bytes than it computes is bounded by
    bytes."""
    b = roofline.anneal_bound(1, 1, 1, 10, 1000)  # 10,000 decisions, no flips counted
    assert b["ops"] == 10_000 * roofline.OPS_PER_DECISION
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx(1e3 * max(10_000 * 29 / 33.5e12,
                                                    10_000 * 10 / 16.75e12))
    b = roofline.anneal_bound(1, 1, 1, 10, 1000, flips=5_000)
    assert b["ops"] == 10_000 * 29 + 5_000 * 10
    assert b["bound_ms"] == pytest.approx(1e3 * (10_000 * 29 + 50_000) / 33.5e12)
    b = roofline.anneal_bound(1, 1, 1, 2000, 1)  # a 16 MB J_g read for 2,000 decisions
    assert b["bound_by"] == "bytes"
    assert b["bytes"] == 4 * (2000 * 2000 + 2000 + 2 + 2000)
