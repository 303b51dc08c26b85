"""The launch-geometry rules of the anneal kernels, on the CPU: the layout
choice K1 and K2 share (``kernel_call.chain_layout``: a thread a chain,
4, 8 or 16 lanes a chain, or a warp a chain, at the main paths' calls, at
its boundaries and within the card's limits at every shape), K4's geometry
(``wide_cuda.wide_geometry``: chains per block, a warp each, and shared
memory), K3's layout (``pt_cuda.pt_layout``: a rung a thread, on 4, 8 or 16
lanes, or a rung a warp, each forced layout's bounds, and the kernel's), K5's geometry
(``pt_wide_cuda.pt_wide_geometry``: its path, ladders a block or a ladder
over a thread block cluster), its row lists (``pt_wide_cuda.row_lists``)
and the rule that routes a PT call to
K3 or K5 (``pt_wide_cuda.pt_route``) at the shapes the main paths launch,
at the K1/K4 boundary, at the shared layouts' widest shapes and past them
(K4's global-field layout and K5's global path, which leave no n up to
8192 and no M up to 512 refused); the field-drift limit of K4 and of K2's
LANES layout, K5's energy limit, and the roofline bound.
``test_torch_cuda.py`` checks on the card that the kernels accept what
these rules report."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from qbmx_torch.core.qubo import random_qubo_batch, split_qubo
from qbmx_torch.models.cdqbm import cdqbm_a_qubos
from qbmx_torch.samplers import gibbs_cuda, kernel_call, pt_cuda, pt_wide_cuda, sa_cuda, wide_cuda
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
    "search h8": (20, 20, 1000, 9),  # bms_hyper_search's h8 configs, 10 seeds
    "winner curves": (60, 36, 1000, 9),  # bms_winner_curves' default, 30 seeds
    "h8 band": (20, 60, 16, 9),  # the flat_{sa,bms}_h8 band settings
    "warm start": (2, 60, 100, 10),  # the RBM warm start onto a DiscQBM
    "CDQBM (b) sweep": (20, 3, 100, 41),  # the 10-seed CDQBM (b) sweep
    "CDQBM (b) band": (20, 20, 16, 41),  # the cdqbm_b_{sa,bms} band settings
}
WIDTHS = (kernel_call.METROPOLIS, 1, 2, 4)  # K1; K2 single, pair, quad
LAYOUTS = (1, *kernel_call.LANES)  # lanes a chain: THREAD, GROUP 4, 8, 16, LANES


def _within_limits(smem: int, threads: int, grid: tuple) -> None:
    assert 0 < smem <= kernel_call.SMEM_BYTES == 232_448
    assert 0 < threads <= 1024 and threads % 8 == 0
    assert 1 <= grid[0] <= GRID_X and 1 <= grid[1] <= GRID_Y


def _check_chain_layout(lay, G: int, B: int, R: int, n: int) -> None:
    """A K1/K2 layout within the card's limits, with a place for every chain."""
    _within_limits(lay.smem, kernel_call.THREADS, lay.grid)
    assert lay.smem == 4 * n * n
    assert lay.chains_per_block * lay.lanes == kernel_call.THREADS
    assert lay.grid == (math.ceil(B * R / lay.chains_per_block), G)
    assert lay.grid[0] * lay.chains_per_block >= B * R  # every chain has a place
    if lay.lanes > 1:
        assert lay.slots * lay.lanes >= n and lay.slots & (lay.slots - 1) == 0
        assert lay.slots <= kernel_call.MAX_SLOTS == 8  # the kernels' slot buckets
    else:
        assert lay.slots == n <= kernel_call.THREAD_MAX_N


@pytest.mark.parametrize("name", [k for k, v in SHAPES.items() if v[3] <= 241])
def test_k1_layout_within_the_card_limits(name):
    G, B, R, n = SHAPES[name]
    for width in WIDTHS:
        _check_chain_layout(kernel_call.chain_layout(G, B, R, n, width=width), G, B, R, n)


@pytest.mark.parametrize("lanes", LAYOUTS)
@pytest.mark.parametrize("name", [k for k, v in SHAPES.items() if v[3] <= 241])
def test_every_chain_layout_within_the_card_limits(name, lanes):
    """Every layout forced at every shape it holds, for every update width:
    within the card's limits, a place for every chain; refused where it
    cannot hold n (quad below 16 lanes: never)."""
    G, B, R, n = SHAPES[name]
    for width in WIDTHS:
        if n <= kernel_call.max_n(lanes, width):
            _check_chain_layout(kernel_call.chain_layout(G, B, R, n, lanes, width), G, B, R, n)
        else:
            with pytest.raises(ValueError, match="no layout"):
                kernel_call.chain_layout(G, B, R, n, lanes, width)


@pytest.mark.parametrize("name", [k for k, v in SHAPES.items() if v[3] <= 241])
def test_quad_never_gets_fewer_than_16_lanes(name):
    """quad_rule_warp spreads the 16 joint states over 16 lanes: the rule
    never routes quad to 4 or 8 lanes a chain, and a forced 4 or 8 is
    refused."""
    G, B, R, n = SHAPES[name]
    assert kernel_call.chain_layout(G, B, R, n, width=4).lanes in (1, 16, 32)
    for lanes in (4, 8):
        with pytest.raises(ValueError, match="for quad"):
            kernel_call.chain_layout(G, B, R, n, lanes, 4)
    assert kernel_call.max_n(4, 4) == kernel_call.max_n(8, 4) == 0


@pytest.mark.parametrize("name,lanes", [
    ("flagship", 1),  # 120,000 chains at n = 6: a thread a chain
    ("flat CLI defaults", 1),  # 14,600 chains at n = 3
    ("dense bench", 8),  # 6,000 chains at n = 41: 8 lanes a chain, 6 of 8 slots
    ("CDQBM (b)", 32),  # 600 chains: a warp a chain
    ("CDQBM (b) prediction", 16),  # 3,200 chains
    ("n=241", 32),
    ("n=241 many chains", 32),  # 60,000 chains; only a warp holds n = 241
    ("search h8", 1),  # 400,000 chains at n = 9
    ("winner curves", 1),  # 2,160,000 chains
    ("h8 band", 1),  # 19,200 chains
    ("warm start", 4),  # 12,000 chains at n = 10
    ("CDQBM (b) sweep", 8),  # 6,000 chains at n = 41
    ("CDQBM (b) band", 8),  # 6,400 chains
])
def test_k1_layout_chosen(name, lanes):
    assert kernel_call.chain_layout(*SHAPES[name]).lanes == lanes


@pytest.mark.parametrize("name,width,lanes", [
    ("flagship", 2, 1),
    ("flat CLI defaults", 2, 1),  # n = 3: pair takes THREAD at any count
    ("dense bench", 1, 16), ("dense bench", 4, 16),  # K2 single (4 slots at most), quad
    ("CDQBM (b)", 2, 32),
    ("search h8", 2, 1),  # the BMS h8 config: a thread a chain
    ("winner curves", 2, 1),
    ("h8 band", 2, 1),
    ("warm start", 2, 1),
    ("CDQBM (b) sweep", 2, 8),
    ("CDQBM (b) band", 2, 8),
    ("CDQBM (b) prediction", 4, 16),
])
def test_k2_layout_chosen(name, width, lanes):
    assert kernel_call.chain_layout(*SHAPES[name], width=width).lanes == lanes


def test_k1_layout_boundaries():
    """The rule's boundaries, each on both sides: THREAD up to
    ``THREAD_MAX_N`` from min(``THREAD_MIN_CHAINS``,
    ``THREAD_CHAINS_A_VARIABLE``·n) chains on; pair and quad THREAD at any
    count up to ``THREAD_ANY_CHAINS_N``; GROUP at the fewest lanes that put
    ``FILL_LANES`` lanes on the card; LANES below."""
    top = kernel_call.THREAD_MAX_N
    assert top == 32
    for width in WIDTHS:
        for n in (3, 8, 9, 16, top):
            few = min(kernel_call.THREAD_MIN_CHAINS[width],
                      kernel_call.THREAD_CHAINS_A_VARIABLE[width] * n)
            assert kernel_call.chain_layout(1, 1, few, n, width=width).lanes == 1
            if n > kernel_call.THREAD_ANY_CHAINS_N[width]:
                assert kernel_call.chain_layout(1, 1, few - 1, n, width=width).lanes > 1
        assert kernel_call.chain_layout(1, 1, 10**6, top + 1, width=width).lanes > 1
        narrow = kernel_call.THREAD_ANY_CHAINS_N[width]
        if narrow:
            assert kernel_call.chain_layout(1, 1, 1, narrow, width=width).lanes == 1
    assert kernel_call.chain_layout(1, 1, 4_500, 3).lanes == 1  # K1: 1,500 chains a variable
    assert kernel_call.chain_layout(1, 1, 4_499, 3).lanes > 1
    assert kernel_call.chain_layout(1, 1, 15_999, 16).lanes > 1  # at most 16,000
    # was: THREAD only at n ≤ 8 and more than 4,224 chains, a warp a chain
    # else; K1 at 4,224 chains now takes 8 lanes a chain at n = 8 and 9
    few = 32 * kernel_call.NUM_SMS
    assert kernel_call.chain_layout(1, 1, few, 8).lanes == 8
    assert kernel_call.chain_layout(1, 1, few + 1, 8).lanes == 8
    assert kernel_call.chain_layout(1, 1, few + 1, 9).lanes == 8
    assert kernel_call.chain_layout(1, 1, few, 9).lanes == 8
    assert kernel_call.chain_layout(1, 1, few, 9, width=2).lanes == 1
    # GROUP at n = 41: 8 lanes (6 slots) from FILL_LANES / 8 chains, 16 and
    # a warp below
    fill = kernel_call.FILL_LANES
    assert kernel_call.chain_layout(1, 1, math.ceil(fill / 8), 41).lanes == 8
    assert kernel_call.chain_layout(1, 1, math.ceil(fill / 8) - 1, 41).lanes == 16
    assert kernel_call.chain_layout(1, 1, math.ceil(fill / 16) - 1, 41).lanes == 32
    assert kernel_call.chain_layout(1, 1, math.ceil(fill / 4), top + 1).lanes == 8  # 4 hold 32
    assert kernel_call.chain_layout(1, 1, math.ceil(fill / 4), 16).lanes == 4
    assert kernel_call.chain_layout(1, 1, math.ceil(fill / 4), 41, width=4).lanes == 16
    # heat-bath single's GROUP holds at most 4 slots: 16 lanes at n = 41, 8 at 32
    assert kernel_call.GROUP_MAX_SLOTS[1] == 4
    assert kernel_call.chain_layout(1, 1, math.ceil(fill / 8), 41, width=1).lanes == 16
    assert kernel_call.chain_layout(1, 1, math.ceil(fill / 8), 32, width=1).lanes == 8
    # a forced layout, as the checks of each layout ask for it
    assert kernel_call.chain_layout(1, 1, 512, 5, lanes=1).lanes == 1
    assert kernel_call.chain_layout(2, 60, 1000, 6, lanes=32).slots == 1
    assert kernel_call.chain_layout(1, 1, 8, 128, lanes=32).slots == 4
    assert kernel_call.chain_layout(1, 1, 8, 241, lanes=32).slots == 8
    assert kernel_call.chain_layout(1, 1, 8, 41, lanes=8).slots == 8  # 6 slots, rounded up
    assert kernel_call.chain_layout(1, 1, 8, top, lanes=1).slots == top
    # the widest n of each layout, and one past it (was: 41 at 8 lanes, 9 at
    # a thread and 9 at 16 lanes refused; they are layouts now)
    for lanes, widest in ((1, top), (4, 32), (8, 64), (16, 128), (32, 241)):
        assert kernel_call.max_n(lanes) == widest
        kernel_call.chain_layout(1, 1, 8, widest, lanes=lanes)
        if widest < 241:
            with pytest.raises(ValueError, match="no layout"):
                kernel_call.chain_layout(1, 1, 8, widest + 1, lanes=lanes)
    for lanes in (2, 64):
        with pytest.raises(ValueError, match="no layout"):
            kernel_call.chain_layout(1, 1, 8, 9, lanes=lanes)
    with pytest.raises(ValueError, match="exceeds its bound"):
        kernel_call.chain_layout(1, 1, 8, 242)
    with pytest.raises(ValueError, match="unknown update width"):
        kernel_call.chain_layout(1, 1, 8, 9, width=3)


def test_chain_layout_routes_are_named():
    """The names the records and ``chip_smoke.BAND_ROUTES`` use."""
    route = lambda lanes: kernel_call.chain_layout(1, 1, 64, 9, lanes=lanes).route
    assert [route(L) for L in LAYOUTS] == ["a thread a chain", "4 lanes a chain",
                                           "8 lanes a chain", "16 lanes a chain",
                                           "a warp a chain"]


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
    """At the shared layout's widest n one chain a block still fits, and one
    more variable does not.  The rule leaves it earlier: at n = 1056, the
    widest where a block holds 31 chains; past it K4 takes the global-field
    layout, 31 chains a block, at the shared layout's widest too."""
    top = wide_cuda.max_n()
    assert top == 3368
    assert wide_cuda.smem_bytes(top, 1) <= kernel_call.SMEM_BYTES < wide_cuda.smem_bytes(top + 1, 1)
    switch = wide_cuda.switch_n()
    assert switch == 1056
    assert wide_cuda.smem_bytes(switch, 31) <= kernel_call.SMEM_BYTES \
        < wide_cuda.smem_bytes(switch + 1, 31)
    for n in (1024, switch):
        geo = wide_cuda.wide_geometry(2, 20, 100, n)
        _within_limits(geo.smem, geo.threads, geo.grid)
        assert geo.layout == wide_cuda.SHARED and geo.chains_per_block >= 31
    assert wide_cuda.layout_geometry(2, 20, 100, top, wide_cuda.SHARED).chains_per_block == 1
    with pytest.raises(ValueError, match="shared layout's bound"):
        wide_cuda.layout_geometry(2, 20, 100, top + 1, wide_cuda.SHARED)
    for n in (switch + 1, top, top + 1):
        past = wide_cuda.wide_geometry(2, 20, 100, n)
        assert past.layout == wide_cuda.GLOBAL and past.chains_per_block == 31
        _within_limits(past.smem, past.threads, past.grid)


@pytest.mark.parametrize("n,jrow,frow", [(242, 244, 248), (717, 720, 720), (2400, 2400, 2400)])
def test_wide_layout_strides(n, jrow, frow):
    """J's rows padded to 16 bytes; each chain's fields and state bytes
    cover whole tiles of 8 variables, so the last tile's whole-tile reads
    stay inside the chain's rows."""
    assert wide_cuda.row_floats(n) == jrow and jrow % 4 == 0 and jrow - n < 4
    assert frow % 8 == 0 and 0 <= frow - n < 8
    assert wide_cuda.smem_bytes(n, 1) == 4 * (16 * jrow + frow + frow // 4)
    assert wide_cuda.smem_bytes(n, 3) - wide_cuda.smem_bytes(n, 2) == 4 * (frow + frow // 4)


@pytest.mark.parametrize("n", [2, 242, 717, 3368, 3369, 3401, 3624, 3625, 4096, 4100, 8192])
def test_wide_geometry_refuses_no_width(n):
    """K4 takes every n up to 8192 (and past it): the shared layout up to
    1056, the global-field layout past it, whose shared memory holds a
    window's 128×128 diagonal block, the dense pass's two chunks of as many
    floats, and each chain's window fields, state bytes and change list."""
    G, B, R = 2, 20, 100
    geo = wide_cuda.wide_geometry(G, B, R, n)
    _within_limits(geo.smem, geo.threads, geo.grid)
    assert geo.grid == (math.ceil(B * R / geo.chains_per_block), G)
    frow = -(-n // 8) * 8
    if n <= wide_cuda.switch_n():
        assert geo.layout == wide_cuda.SHARED and geo.smem == wide_cuda.smem_bytes(n, geo.chains_per_block)
        return
    assert geo.layout == wide_cuda.GLOBAL and geo.chains_per_block == 31
    assert wide_cuda.global_row_floats(n) == frow
    assert geo.smem == wide_cuda.global_smem_bytes(31) == 4 * 3 * 128 * 128 + 31 * 6 * 128


def test_wide_global_layout_fills_shared_memory_at_its_widest_chunk():
    """The window (rows, and columns a dense chunk) is the widest multiple
    of 8 whose diagonal block, two dense chunks and 32 chains' window rows
    fit a block: 128 takes 221,184 of its 232,448 bytes, 136 would take
    248,064."""
    assert wide_cuda.WINDOW % 8 == 0
    assert wide_cuda.global_smem_bytes(32) == 221_184 <= kernel_call.SMEM_BYTES
    W = wide_cuda.WINDOW + 8
    assert 4 * 3 * W * W + 32 * 6 * W > kernel_call.SMEM_BYTES
    assert wide_cuda.global_smem_bytes(32, sparse=True) == 4 * 128 * 128 + 32 * 6 * 128
    # a forced layout, as the checks of the layouts' bit equality ask for it
    geo = wide_cuda.WideGeometry.of(2, 3, 20, 717, 7, wide_cuda.GLOBAL)
    assert geo.layout == wide_cuda.GLOBAL and geo.grid == (9, 2)
    assert geo.smem == 4 * 3 * 128 * 128 + 7 * 6 * 128
    with pytest.raises(ValueError, match="unknown layout"):
        wide_cuda.WideGeometry.of(1, 1, 1, 8, 1, "registers")


@pytest.mark.parametrize("n", [2609, 3369, 3401, 4096, 4100, 8191, 8192])
@pytest.mark.parametrize("sparse", [False, True])
def test_window_geometry_within_the_card_limits(n, sparse):
    """The global-field layout's windows at widths up to 8192: ⌈n / 128⌉
    windows of 128 rows (the last one shorter), each a multiple of 8 fields
    within the chain's padded row, and every block of 1 to 32 chains (K5:
    warps) within the card's shared memory, on either pass; the dense
    pass's chunks cover the padded row, one of them the window's own
    columns."""
    W, frow = wide_cuda.WINDOW, wide_cuda.global_row_floats(n)
    windows = -(-n // W)
    starts = [k * W for k in range(windows)]
    assert starts[-1] < n <= starts[-1] + W
    fields = [min(W, frow - w0) for w0 in starts]
    assert all(f % 8 == 0 and f > 0 for f in fields) and sum(fields) == frow
    assert -(-frow // W) == windows  # a chunk per window: the pass skips its own
    for chains in (1, 7, 31, 32):
        smem = wide_cuda.global_smem_bytes(chains, sparse)
        _within_limits(smem, 32 * chains, (1, 1))
        geo = wide_cuda.WideGeometry.of(2, 20, 100, n, chains, wide_cuda.GLOBAL)
        assert geo.smem == wide_cuda.global_smem_bytes(chains) >= smem
        pt = pt_wide_cuda.PTWideGeometry.global_path(2, 20, 8, 100, n, chains)
        assert pt.smem == geo.smem and pt.threads == 32 * chains


def test_density_rule_is_one_constant():
    """The global-field layouts' sparse pass takes a call whose densest
    group holds at most ``SPARSE_DENSITY`` · n² nonzeros, and n ≤ 32768
    (the row lists' 16-bit columns); the dense pass takes the rest: a pure
    function of J_g's nonzeros a row and n, on either side of the constant."""
    n = 1000
    limit = int(wide_cuda.SPARSE_DENSITY * n * n)
    at = torch.zeros((2, n), dtype=torch.int32)
    at[1, :limit % n] = limit // n + 1
    at[1, limit % n:] = limit // n
    assert int(at[1].sum()) == limit
    assert wide_cuda.sparse_pass(at, n)
    over = at.clone()
    over[1, 0] += 1
    assert not wide_cuda.sparse_pass(over, n)
    # the densest group decides, not the mean over groups
    spread = torch.full((2, n), limit // n // 2 + 1, dtype=torch.int32)
    assert wide_cuda.sparse_pass(spread, n)
    lopsided = torch.cat([over[1:], torch.zeros((1, n), dtype=torch.int32)])
    assert not wide_cuda.sparse_pass(lopsided, n)
    # past 16-bit columns, the dense pass whatever the density
    assert wide_cuda.sparse_pass(torch.zeros((1, 32768), dtype=torch.int32), 32768)
    assert not wide_cuda.sparse_pass(torch.zeros((1, 32769), dtype=torch.int32), 32769)


@pytest.mark.parametrize("restricted", [True, False])
def test_density_rule_at_the_h3400_step(restricted):
    """``qbm_main -hn 3400``'s step call: restricted (``qm.main``'s default:
    J_g all zeros but the output's row and column, 6,800 nonzeros in the
    unclamped group) on the sparse pass; as the CLI runs it (``-r False``:
    a dense strictly-upper ``w_hh``) on the dense pass."""
    n = 3401
    counts = torch.zeros((2, n), dtype=torch.int32)
    if restricted:
        counts[1, 0], counts[1, 1:] = n - 1, 1
    else:
        counts[0, 1:], counts[1] = n - 2, n - 1
    assert wide_cuda.sparse_pass(counts, n) == restricted


def test_k1_k4_boundary():
    """K1 (J_g in shared memory) up to n = 241, K4 above."""
    assert kernel_call.fits_shared(241) and not kernel_call.fits_shared(242)
    assert kernel_call.chain_layout(2, 3, 100, 241).smem <= kernel_call.SMEM_BYTES
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


def test_roofline_counts_the_global_fields_traffic():
    """The global-field layouts' least traffic: each sweep reads and writes
    each chain's fields (4 bytes) and state (1 byte), rows of n rounded up
    to 8; ``layout_bytes`` adds it to the bound's bytes, nothing else."""
    assert roofline.global_field_bytes(4000, 3401, 5) == 4000 * 5 * 2 * 5 * 3408
    plain = roofline.anneal_bound(2, 20, 100, 3401, 5, flip_work=10**9)
    extra = roofline.global_field_bytes(4000, 3401, 5)
    held = roofline.anneal_bound(2, 20, 100, 3401, 5, flip_work=10**9, layout_bytes=extra)
    assert held["bytes"] == plain["bytes"] + extra and held["ops"] == plain["ops"]
    assert held["bound_ms"] >= plain["bound_ms"]


def _cdqbm_a_J() -> torch.Tensor:
    """CDQBM (a)'s step couplings J (2, 717, 717), on the CPU."""
    return split_qubo(cdqbm_a_qubos(3, torch.device("cpu"), seed=1)[0])[1]


@pytest.mark.parametrize("problem", ["dense", "CDQBM (a)"])
def test_roofline_counts_the_changed_rows_nonzeros(problem):
    """The changes' FMAs are the nonzeros of the changed rows (K4's and
    K5's second counter, from ``pt_wide_cuda.row_nnz`` on the dense paths):
    on a J without zeros that is flips·n, the count the bound took before;
    on CDQBM (a)'s J, each variable changed once, it is J's nonzero count,
    a fiftieth of flips·n."""
    rng = np.random.default_rng(4)
    n = 717
    J = torch.as_tensor(rng.uniform(0.5, 1.0, (2, n, n)).astype(np.float32)) \
        if problem == "dense" else _cdqbm_a_J()
    nnz = pt_wide_cuda.row_nnz(J)
    changes = torch.ones((2, n), dtype=torch.int64) if problem == "CDQBM (a)" else \
        torch.as_tensor(rng.integers(0, 5, (2, n)))
    flips, work = int(changes.sum()), int((changes * nnz).sum())
    if problem == "dense":
        assert work == flips * n
        assert roofline.anneal_bound(2, 20, 100, n, 10, rungs=8, flip_work=work) == \
            roofline.anneal_bound(2, 20, 100, n, 10, rungs=8, flips=flips)
    else:
        assert work == int((J != 0).sum()) == 10_092 + 10_100 and 50 * work < flips * n
        b = roofline.anneal_bound(2, 20, 100, n, 1000, rungs=8, flip_work=work)
        assert b["ops"] == 2 * 20 * 8 * 100 * n * 1000 * roofline.OPS_PER_DECISION + work


class _Picked(Exception):
    """Raised by a stand-in layout rule once a wrapper has asked it."""


@pytest.mark.parametrize("name", ["flagship", "dense bench", "CDQBM (b)", "search h8",
                                  "CDQBM (b) sweep"])
def test_k1_and_k2_take_their_layout_from_one_rule(monkeypatch, name):
    """The launches of K1 (``sa_cuda.launch``) and K2 (``gibbs_cuda.launch``)
    ask the one rule, ``kernel_call.chain_layout``, with the same
    arguments but their update width (K1's ``METROPOLIS``, K2's 1, 2 or
    4)."""
    from qbmx_torch import _build

    G, B, R, n = SHAPES[name]
    asked = []

    def rule(*args):
        asked.append(args)
        raise _Picked

    class Lib:  # the bound each wrapper reads before its layout
        qbmx_sa_metropolis_max_n = qbmx_sa_heatbath_max_n = staticmethod(lambda: 241)

    monkeypatch.setattr(_build, "load_kernels", lambda: Lib)
    monkeypatch.setattr(kernel_call, "chain_layout", rule)
    J, h = torch.zeros((G, n, n)), torch.zeros((G, B, n))
    hot, logr = torch.ones((G, B)), torch.zeros((G, B))
    with pytest.raises(_Picked):
        sa_cuda.launch(J, h, hot, logr, R, 10)
    for width in (1, 2, 4):
        with pytest.raises(_Picked):
            gibbs_cuda.launch(J, h, hot, logr, R, 10, width)
    assert asked == [(G, B, R, n, None, width) for width in WIDTHS]


PT_SHAPES = {  # (B, M, R, n)
    "flagship PT": (120, 8, 1000, 6),  # the flat Disc_QBM densified at H=5
    "CLI defaults PT": (146, 8, 100, 3),
    "one rung": (3, 1, 100, 5),
    "odd ladder": (3, 5, 100, 7),
    "32 rungs": (2, 32, 50, 8),
    "33 rungs": (2, 33, 50, 8),
    "n=41": (60, 8, 100, 41),
    "n=100 M=32": (2, 32, 8, 100),  # M·n = 3,200
    "n=240 M=64": (1, 64, 10, 240),  # M·n = 15,360
    "n=241 M=8": (4, 8, 32, 241),
    "n=241 M=15": (1, 15, 4, 241),  # the widest ladder at n = 241
    # the users' calls past n = 8
    "flat PT h8": (120, 8, 1000, 9),  # qbm_main --solver PT -hn 8 at the flagship's reads
    "flat PT h8 sweep": (1200, 8, 1000, 9),  # its --seed_sweep 0..9
    "qm.main PT": (20, 8, 100, 11),  # qm.main()'s n_hidden_nodes=10
    "CDQBM (b) PT": (6, 8, 100, 41),  # cdqbm_main --solver PT
    "CDQBM (b) PT sweep": (60, 8, 100, 41),  # its --seed_sweep 0..9
    "n=32 M=16": (4, 16, 20, 32),  # RUNG's widest
    "n=33 M=4": (4, 4, 20, 33),
}


def _pt_takes(lanes: int, n: int, M: int) -> bool:
    """Whether K3's layout of ``lanes`` lanes a rung holds n and M."""
    return n <= pt_cuda.max_n(lanes) and (lanes != pt_cuda.RUNG or M <= pt_cuda.RUNG_MAX_M)


@pytest.mark.parametrize("name", list(PT_SHAPES))
def test_pt_layout_within_the_card_limits(name):
    """The rule's layout and every layout forced that takes the shape:
    within the card's limits, every ladder placed, a ladder within one warp
    or one block; a forced layout that does not take the shape raises."""
    B, M, R, n = PT_SHAPES[name]
    for lanes in (None, *pt_cuda.LAYOUTS):
        if lanes is not None and not _pt_takes(lanes, n, M):
            with pytest.raises(ValueError, match="no layout of"):
                pt_cuda.pt_layout(B, M, R, n, lanes)
            continue
        lay = pt_cuda.pt_layout(B, M, R, n, lanes)
        assert lanes in (None, lay.lanes)
        _within_limits(lay.smem, lay.threads, lay.grid)
        assert lay.grid[1] == B and lay.grid[0] * lay.ladders_per_block >= R  # every ladder placed
        assert lay.smem == pt_cuda.smem_bytes(lay.lanes, n, M)
        if lay.lanes == pt_cuda.RUNG or M * lay.lanes <= 32:  # ladders within a warp
            stride = n if lay.lanes > 1 or n <= 8 else 4 * math.ceil(n / 4)
            assert n <= pt_cuda.max_n(lay.lanes) and M <= 32 and lay.threads == 128
            assert lay.smem == 4 * n * stride
            assert lay.ladders_per_block == 4 * (32 // (M * lay.lanes))
            assert lay.grid == (math.ceil(R / lay.ladders_per_block), B)
        elif lay.lanes == pt_cuda.WARP:
            assert lay.rungs_per_warp == (1 if M <= 32 else 2) and lay.ladders_per_block == 1
            assert lay.threads == 32 * math.ceil(M / lay.rungs_per_warp)
            assert lay.smem == 4 * (n * n + 2 * M) and lay.grid == (R, B)
        else:  # a GROUP ladder over warps: a block
            assert lay.threads == 32 * math.ceil(M * lay.lanes / 32) >= M * lay.lanes
            assert lay.smem == 4 * (n * n + 2 * M) and lay.grid == (R, B)
            assert lay.ladders_per_block == 1 and n <= 8 * lay.lanes


@pytest.mark.parametrize("name,lanes", [
    ("flagship PT", pt_cuda.RUNG), ("CLI defaults PT", pt_cuda.RUNG), ("one rung", pt_cuda.RUNG),
    ("odd ladder", pt_cuda.RUNG), ("32 rungs", pt_cuda.RUNG),
    ("33 rungs", 4),  # more rungs than a warp has lanes: a GROUP ladder over 5 warps
    ("n=41", 8), ("n=100 M=32", pt_cuda.WARP), ("n=241 M=8", pt_cuda.WARP),
    ("flat PT h8", pt_cuda.RUNG), ("flat PT h8 sweep", pt_cuda.RUNG),
    ("qm.main PT", pt_cuda.RUNG), ("CDQBM (b) PT", 16), ("CDQBM (b) PT sweep", 8),
    ("n=32 M=16", 8),  # 1,280 rungs: 8 lanes, 4 slots
    ("n=33 M=4", 16),  # 320 rungs
])
def test_pt_layout_chosen(name, lanes):
    assert pt_cuda.pt_layout(*PT_SHAPES[name]).lanes == lanes


@pytest.mark.parametrize("lanes,route", [
    (pt_cuda.RUNG, "a rung a thread"), (4, "4 lanes a rung"), (8, "8 lanes a rung"),
    (16, "16 lanes a rung"), (pt_cuda.WARP, "a rung a warp")])
def test_pt_layout_names_its_route(lanes, route):
    assert pt_cuda.pt_layout(2, 4, 10, 9, lanes).route == route


def test_pt_layout_bounds():
    """Every ladder the one-thread design took (n ≤ 241, M ≤ 64, M·n ≤
    2048) and more: M·n is not bounded, every M ≤ 64 up to n = 240 and
    M ≤ 15 at n = 241, where J_b and the exchanged energies fill shared
    memory; and each layout's own bounds (RUNG n ≤ 32, M ≤ 32; GROUP
    n ≤ 8 lanes)."""
    for n in range(1, 242):
        for M in sorted({1, 2, 8, min(64, 2048 // n)}):
            lay = pt_cuda.pt_layout(2, M, 10, n)
            assert n <= pt_cuda.max_n(lay.lanes)
    for n in (100, 240):
        assert pt_cuda.pt_layout(1, 64, 1, n).lanes == pt_cuda.WARP
    assert pt_cuda.pt_layout(1, 64, 1, 9).lanes == 4  # a ladder of 64 rungs over 8 warps
    assert pt_cuda.pt_layout(1, 15, 1, 241).smem <= kernel_call.SMEM_BYTES
    assert 241 * 9 > 2048 and pt_cuda.pt_layout(1, 9, 1, 241).lanes == pt_cuda.WARP
    for n, M in ((242, 1), (4, 65), (241, 16), (0, 4), (4, 0)):
        with pytest.raises(ValueError, match="exceed its bound"):
            pt_cuda.pt_layout(1, M, 1, n)
    with pytest.raises(ValueError, match="grid"):
        pt_cuda.pt_layout(65536, 8, 1, 6)
    # a forced layout, as the checks of each layout ask for it
    assert pt_cuda.pt_layout(120, 8, 1000, 6, pt_cuda.WARP).lanes == pt_cuda.WARP
    assert [pt_cuda.max_n(L) for L in pt_cuda.LAYOUTS] == [32, 32, 64, 128, 241]
    for n, M, lanes in ((33, 8, pt_cuda.RUNG), (6, 33, pt_cuda.RUNG), (33, 2, 4), (65, 2, 8),
                        (129, 2, 16)):
        with pytest.raises(ValueError, match="no layout of"):
            pt_cuda.pt_layout(1, M, 1, n, lanes)
    with pytest.raises(ValueError, match="unknown layout"):
        pt_cuda.pt_layout(1, 2, 1, 6, 2)
    # RUNG past n = 8 only for many rungs; the n ≤ 8 calls keep it at any count
    assert pt_cuda.pt_layout(1, 8, 1, 8).lanes == pt_cuda.RUNG
    assert pt_cuda.pt_layout(1, 8, 1, 9).lanes != pt_cuda.RUNG
    for n in range(9, 33):
        few = min(pt_cuda.RUNG_MIN_RUNGS, pt_cuda.RUNG_RUNGS_A_VARIABLE * n)
        assert pt_cuda.pt_layout(1, 8, math.ceil(few / 8), n).lanes == pt_cuda.RUNG
        assert pt_cuda.pt_layout(1, 8, math.ceil(few / 8) - 1, n).lanes in pt_cuda.GROUP_LANES
    # GROUP: 4 slots a lane on an idle card, up to 8 where the rungs fill it
    assert pt_cuda.pt_layout(6, 8, 100, 41).lanes == 16  # 4,800 rungs: 16 x 3 slots
    assert pt_cuda.pt_layout(15, 8, 100, 41).lanes == 8  # 12,000: 8 x 6
    assert pt_cuda.pt_layout(1, 8, 10, 100).lanes == pt_cuda.WARP  # 80 rungs at n = 100


def test_k2_field_drift_limit_catches_one_lost_add():
    """K2's LANES layout refreshes its fields every 16th sweep: at the
    CDQBM default call (n = 41, S = 1000) its drift limit lies below every
    row's median |J_jk|, and covers the adds of the 8 sweeps since the
    last refresh."""
    n, S = 41, 1000
    rng = np.random.default_rng(n)
    hs, J = split_qubo(random_qubo_batch(rng, 2, n))
    h = hs[:, None, :] + torch.as_tensor(rng.normal(size=(2, 3, n)).astype(np.float32))
    bound = wide_cuda.field_drift_bound(h, J, S, gibbs_cuda.REFRESH_PERIOD)
    typical = J.abs().masked_fill(J == 0, float("nan")).nanmedian(dim=2).values  # (2, n)
    assert (bound[:, :, 0] < typical[:, None].double()).all()
    scale = h.double().abs() + J.double().abs().sum(-1)[:, None, :]
    assert torch.allclose(bound[:, :, 0], math.sqrt(n + 1 + n * 8) * 2.0**-24 * scale)
    assert (bound < wide_cuda.field_drift_bound(h, J, S)).all()  # K4's period, 40 sweeps since


@pytest.mark.parametrize("n", [1, 2, 3, 6, 7, 41, 42, 43, 241])
def test_heatbath_units_count_the_sweep(n):
    """A heat-bath sweep's decisions (one draw each) at every width: n
    singles; ⌈n/2⌉ pairs and a trailing single; quads, then a remainder pair
    and/or single -- the plain version's schedule."""
    assert roofline.heatbath_units(n, 1) == n
    assert roofline.heatbath_units(n, 2) == n // 2 + n % 2
    r = n % 4
    assert roofline.heatbath_units(n, 4) == n // 4 + (r >= 2) + r % 2
    with pytest.raises(ValueError):
        roofline.heatbath_units(n, 3)


def test_k2_bound_at_the_cdqbm_default_call():
    """K2 pair at G=2 B=3 n=41 R=100 S=1000: 21 draws a sweep, bounded by
    operations at ~0.011 ms on the H100's issue rate."""
    b = roofline.anneal_bound(2, 3, 100, 41, 1000,
                              decisions=2 * 3 * 100 * roofline.heatbath_units(41, 2) * 1000)
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx(1e3 * 2 * 3 * 100 * 21 * 1000 * 29 / 33.5e12)
    assert round(b["bound_ms"], 3) == 0.011


PT_WIDE_SHAPES = {  # (G, B, M, R, n)
    "CDQBM (a) PT": (2, 20, 8, 100, 717),
    "CDQBM (a) PT prediction": (1, 32, 8, 100, 717),
    "n=241 M=16": (1, 4, 16, 32, 241),
    "n=300": (2, 4, 8, 16, 300),
    "one ladder a block": (1, 2, 32, 4, 242),
    "widest n": (1, 1, 1, 10, 3368),       # the sparse path, or past n = 1056 the global one
    "65 rungs": (1, 1, 65, 8, 4),          # past K3: a cluster of 3 blocks
    "n=300 M=33": (1, 2, 33, 4, 300),      # past a block's warps: 2 blocks
    "n=3000 M=3": (1, 2, 3, 3, 3000),      # past what a block's memory holds
    "widest ladder": (1, 1, 256, 2, 717),  # 8 blocks of 32 warps
    "widest n, widest ladder": (1, 1, 8, 2, 3368),
    "qbm_main -hn 3400 PT": (2, 20, 8, 100, 3401),   # past n = 3368: the global path
    "n=3000 M=24": (1, 1, 24, 4, 3000),   # past a cluster of the dense path's 2-rung blocks
    "n=300 M=300": (1, 1, 300, 2, 300),   # past a cluster of 32-warp blocks
    "n=8192": (1, 2, 2, 4, 8192),
}
CDQBM_A_NNZ_PAD = 10_104  # CDQBM (a)'s row lists: 10,100 nonzeros in the larger group


@pytest.mark.parametrize("nnz_pad", [None, 8, CDQBM_A_NNZ_PAD])
@pytest.mark.parametrize("name", list(PT_WIDE_SHAPES))
def test_pt_wide_geometry_within_the_card_limits(name, nnz_pad):
    G, B, M, R, n = PT_WIDE_SHAPES[name]
    geo = pt_wide_cuda.pt_wide_geometry(G, B, M, R, n, nnz_pad)
    _within_limits(geo.smem, geo.threads, geo.grid)
    L, K, W = geo.ladders_per_block, geo.cluster, geo.warps
    assert geo.threads == 32 * W <= 1024  # a warp a rung
    if geo.path == pt_wide_cuda.GLOBAL:  # any ladder over any blocks, S + 1 launches
        assert n > pt_wide_cuda.switch_n() or M > pt_wide_cuda.max_rungs(n)
        assert W == pt_wide_cuda.global_warps(G, B, M, R) and geo.ladders_per_block == 0
        assert geo.smem == wide_cuda.global_smem_bytes(W) and geo.grid == (math.ceil(B * R * M / W), G)
        return
    if geo.path == pt_wide_cuda.DENSE:
        assert n <= pt_wide_cuda.switch_n()
        assert geo.smem == pt_wide_cuda.smem_bytes(n, W) == wide_cuda.smem_bytes(n, W) + 8 * W
    else:
        assert nnz_pad is not None and geo.nnz_pad == nnz_pad and n <= pt_wide_cuda.max_n()
        assert geo.smem == pt_wide_cuda.sparse_smem_bytes(n, W, nnz_pad) \
            == 6 * nnz_pad + 4 * pt_wide_cuda.offsets_len(n) + pt_wide_cuda.smem_bytes(n, W) \
            - pt_wide_cuda.smem_bytes(n, 0)
    if K == 1:  # whole ladders a block
        assert W == M * L and geo.grid == (math.ceil(B * R / L), G) and geo.grid[0] * L >= B * R
    else:  # one ladder over K blocks, each holding a rung, within the portable cluster size
        assert L == 1 and 2 <= K <= pt_wide_cuda.MAX_CLUSTER and W == math.ceil(M / K)
        assert (K - 1) * W < M <= K * W and geo.grid == (B * R * K, G)
        assert W < M and pt_wide_cuda.block_rungs(n, geo.nnz_pad or None) < M


def test_pt_wide_geometry_at_the_cdqbm_shape():
    """CDQBM (a)'s PT call: 32,000 rungs, 4 ladders (32 warps) a block,
    1,000 blocks, one an SM: on the sparse path, its row lists (60,624
    bytes of values and columns, 2,880 of offsets) beside the rungs in
    178,960 bytes; on the dense path (a random QUBO), two J tiles beside
    them in 161,536."""
    shape = PT_WIDE_SHAPES["CDQBM (a) PT"]
    geo = pt_wide_cuda.pt_wide_geometry(*shape, CDQBM_A_NNZ_PAD)
    assert (geo.path, geo.ladders_per_block, geo.cluster, geo.threads, geo.grid) == \
        (pt_wide_cuda.SPARSE, 4, 1, 1024, (500, 2))
    assert geo.smem == 6 * 10_104 + 4 * 720 + 4 * 32 * (720 + 180) + 8 * 32 == 178_960
    dense = pt_wide_cuda.pt_wide_geometry(*shape)
    assert (dense.path, dense.ladders_per_block, dense.threads, dense.grid) == \
        (pt_wide_cuda.DENSE, 4, 1024, (500, 2))
    assert dense.smem == 4 * (16 * 720 + 32 * (720 + 180)) + 8 * 32 == 161_536
    assert 2 * geo.smem > 2 * dense.smem > kernel_call.SMEM_BYTES
    few = pt_wide_cuda.pt_wide_geometry(1, 1, 8, 10, 717, CDQBM_A_NNZ_PAD)  # 10 ladders
    assert few.ladders_per_block == 1 and few.grid == (10, 1) and few.path == pt_wide_cuda.SPARSE
    # row lists too long to fit beside a rung: the dense path
    assert pt_wide_cuda.pt_wide_geometry(*shape, 40_000).path == pt_wide_cuda.DENSE
    assert pt_wide_cuda.pt_wide_geometry(1, 1, 256, 2, 717, 30_000).path == pt_wide_cuda.DENSE


def test_pt_wide_bounds():
    """K5's shared paths hold K4's shared widths (n ≤ 3368) and every ladder
    whose rungs fit a cluster of 8 blocks, each of up to 32 warps beside two
    J tiles: 256 rungs up to n = 2600 or so, 16 at n = 3000, 8 at n = 3368.
    The rule gives the dense path n ≤ 1416 (20 rungs a block); past it, and
    past those ladders, the global path takes the call; only an empty shape
    or more than 65,535 groups raise."""
    assert pt_wide_cuda.max_n() == wide_cuda.max_n() == 3368
    assert pt_wide_cuda.block_rungs(241) == pt_wide_cuda.block_rungs(717) == 32
    assert pt_wide_cuda.max_rungs(241) == pt_wide_cuda.max_rungs(717) == 256
    assert pt_wide_cuda.max_rungs(3000) == 16
    assert pt_wide_cuda.max_rungs(3368) == 8 and pt_wide_cuda.max_rungs(3369) == 0
    assert pt_wide_cuda.switch_n() == 1416
    assert pt_wide_cuda.block_rungs(pt_wide_cuda.switch_n()) == 20
    assert pt_wide_cuda.block_rungs(pt_wide_cuda.switch_n() + 1) == 19
    for n in (242, 717, 1500, 2600, 3000, 3368):
        W = pt_wide_cuda.block_rungs(n)
        M = pt_wide_cuda.max_rungs(n)
        assert M == 8 * W and 1 <= W <= 32
        assert pt_wide_cuda.smem_bytes(n, W) <= kernel_call.SMEM_BYTES
        rule = pt_wide_cuda.pt_wide_geometry if n <= pt_wide_cuda.switch_n() else \
            pt_wide_cuda.shared_geometry
        assert rule(1, 1, W, 1, n).cluster == 1
        assert rule(1, 1, M, 1, n).cluster == 8
        if W < 32:
            assert pt_wide_cuda.smem_bytes(n, W + 1) > kernel_call.SMEM_BYTES
            assert rule(1, 1, W + 1, 1, n).cluster == 2
        assert pt_wide_cuda.pt_wide_geometry(1, 1, M + 1, 1, n).path == pt_wide_cuda.GLOBAL
        with pytest.raises(ValueError, match="shared paths' bounds"):
            pt_wide_cuda.shared_geometry(1, 1, M + 1, 1, n)
        if n > pt_wide_cuda.switch_n():
            assert pt_wide_cuda.pt_wide_geometry(1, 1, M, 1, n).path == pt_wide_cuda.GLOBAL
    for n, M in ((3369, 1), (300, 257), (3000, 17), (3368, 9), (2609, 1)):
        assert pt_wide_cuda.pt_wide_geometry(1, 1, M, 1, n).path == pt_wide_cuda.GLOBAL
    for n, M in ((0, 4), (300, 0)):
        with pytest.raises(ValueError, match="no problem to sample"):
            pt_wide_cuda.pt_wide_geometry(1, 1, M, 1, n)
    with pytest.raises(ValueError, match="grid"):
        pt_wide_cuda.pt_wide_geometry(65536, 1, 8, 1, 300)
    # the sparse path's rungs a block, beside its row lists
    assert pt_wide_cuda.block_rungs(717, CDQBM_A_NNZ_PAD) == 32
    assert pt_wide_cuda.block_rungs(717, 30_000) == 13
    assert pt_wide_cuda.block_rungs(717, 40_000) == 0


@pytest.mark.parametrize("shape,kernel", [
    ((2, 60, 8, 1000, 6), "pt_heatbath"),     # the flagship, densified: K3 a rung a thread
    ((20, 60, 8, 1000, 6), "pt_heatbath"),    # the 10-seed flagship sweep
    ((2, 73, 8, 100, 3), "pt_heatbath"),      # the flat CLI defaults
    ((1, 4, 15, 32, 241), "pt_heatbath"),     # K3's widest ladder at n = 241
    ((1, 1, 64, 10, 240), "pt_heatbath"),
    ((1, 4, 16, 32, 241), "pt_wide"),         # J_b and 32 energies past shared memory
    ((2, 20, 8, 100, 717), "pt_wide"),        # CDQBM (a)
    ((1, 32, 8, 100, 717), "pt_wide"),        # its prediction chunk
    ((1, 1, 2, 4, 242), "pt_wide"),
    ((1, 1, 1, 4, 3368), "pt_wide"),
    ((1, 1, 65, 2, 4), "pt_wide"),            # past K3's 64 rungs: a cluster
    ((1, 1, 33, 2, 300), "pt_wide"),
    ((1, 1, 3, 2, 3000), "pt_wide"),
])
def test_pt_route(shape, kernel):
    assert pt_wide_cuda.pt_route(*shape) == kernel


def test_pt_route_takes_the_union_of_the_bounds():
    """A PT call launches K3 where it takes the shape, else K5: its dense
    path where the rule gives it the call (n ≤ 1416, the ladder within a
    cluster), its global path beyond, so that no shape raises (the cases
    that raised before this layout now take the global path, one for one)."""
    for n in (1, 6, 8, 9, 100, 240, 241, 242, 300, 717, 1024, 2000, 3000, 3368, 3369):
        for M in (1, 2, 8, 9, 15, 16, 17, 32, 33, 64, 65, 256, 257):
            k3 = n <= 241 and M <= 64 and 4 * (n * n + 2 * M) <= kernel_call.SMEM_BYTES
            k5 = n <= pt_wide_cuda.switch_n() and M <= 8 * pt_wide_cuda.block_rungs(n)
            assert pt_wide_cuda.pt_route(1, 2, M, 3, n) == ("pt_heatbath" if k3 else "pt_wide")
            if not k3:
                path = pt_wide_cuda.pt_wide_geometry(1, 2, M, 3, n).path
                assert (path == pt_wide_cuda.GLOBAL) == (not k5)


@pytest.mark.parametrize("n", [242, 3369, 4096, 4100, 8192])
def test_pt_route_refuses_no_width_or_ladder(n):
    """No n up to 8192 and no M up to 512 is refused; the global path's
    Philox variable block widens past n = 4092 (its counter's rung keeps
    ≥ 10 bits: M up to 2^20 and more)."""
    for M in (1, 2, 8, 9, 33, 256, 257, 300, 512):
        assert pt_wide_cuda.pt_route(1, 2, M, 3, n) == "pt_wide"
        geo = pt_wide_cuda.pt_wide_geometry(1, 2, M, 3, n)
        _within_limits(geo.smem, geo.threads, geo.grid)
    shift = pt_wide_cuda.var_shift(n)
    assert -(-n // 4) <= (1 << shift) - 1 and 512 <= 1 << (32 - shift)
    assert shift == (10 if n <= 4092 else 11 if n <= 8188 else 12)
    with pytest.raises(ValueError, match="grid"):
        pt_wide_cuda.pt_route(65536, 1, 8, 1, n)


def test_energy_drift_limit_catches_one_lost_flip():
    """K5's energies at the CDQBM (a) depth: the limit covers the fields'
    drift and one sum's rounding, and lies below one flip's |f_i|, the
    energy change a lost update would leave out."""
    n, S = 717, 1000
    rng = np.random.default_rng(n)
    hs, J = split_qubo(random_qubo_batch(rng, 2, n))
    h = hs[:, None, :] + torch.as_tensor(rng.normal(size=(2, 3, n)).astype(np.float32))
    bound = pt_wide_cuda.energy_drift_bound(h, J, S)
    assert bound.shape == (2, 3, 1, 1) and bound.dtype == torch.float64
    fb = wide_cuda.field_drift_bound(h, J, S)
    scale = 2 * h.double().abs() + J.double().abs().sum(-1)[:, None, :]
    assert torch.allclose(bound[..., 0, 0], 0.5 * fb[:, :, 0].sum(-1)
                          + math.sqrt(n) * 2.0**-24 * scale.sum(-1))
    s = torch.as_tensor((rng.random((n,)) < 0.5).astype(np.float64))
    fields = h.double()[0, 0] + J.double()[0] @ s
    assert fields.abs().median() > bound.max()


@pytest.mark.parametrize("problem", ["random sparse", "CDQBM (a)", "empty rows"])
def test_row_lists_hold_the_nonzeros_in_order(problem):
    """``pt_wide_cuda.row_lists`` against the dense J: each row's entries
    are its nonzeros, bit for bit, at increasing columns; the offsets count
    them; the padding is zeros, to a multiple of 8 entries."""
    rng = np.random.default_rng(12)
    if problem == "CDQBM (a)":
        J = _cdqbm_a_J()
    else:
        n = 50
        J = torch.as_tensor(rng.normal(size=(3, n, n)).astype(np.float32))
        J = J * torch.as_tensor(rng.random((3, n, n)) < 0.1)
        J = J + J.transpose(1, 2)
        J[:, torch.arange(n), torch.arange(n)] = 0
        if problem == "empty rows":
            J[1] = 0  # a group without couplings
            J[2, :7] = 0
            J[2, :, :7] = 0
            J[0, 3, 4] = J[0, 4, 3] = -0.0  # a signed zero is no nonzero
    G, n, _ = J.shape
    rows = pt_wide_cuda.row_lists(J)
    counts = (J != 0).sum(-1)
    assert rows.nnz == tuple(counts.sum(-1).tolist())
    assert rows.nnz_pad % 8 == 0 and rows.nnz_pad >= max(8, max(rows.nnz))
    assert rows.vals.dtype == torch.float32 and rows.cols.dtype == torch.int16
    assert rows.offsets.dtype == torch.int32
    assert rows.offsets.shape == (G, pt_wide_cuda.offsets_len(n))
    assert rows.offsets.shape[1] % 4 == 0 and rows.offsets.shape[1] >= n + 1
    for g in range(G):
        off = rows.offsets[g].tolist()
        assert off[0] == 0 and off[n:] == [rows.nnz[g]] * (len(off) - n)
        for i in range(n):
            cols = rows.cols[g, off[i]:off[i + 1]].long()
            want = torch.nonzero(J[g, i])[:, 0]
            assert torch.equal(cols, want)  # increasing columns
            assert torch.equal(rows.vals[g, off[i]:off[i + 1]].view(torch.int32),
                               J[g, i, want].view(torch.int32))  # bit for bit
        assert not rows.vals[g, rows.nnz[g]:].any() and not rows.cols[g, rows.nnz[g]:].any()
    if problem == "CDQBM (a)":
        assert rows.nnz == (10_092, 10_100) and rows.nnz_pad == CDQBM_A_NNZ_PAD
        assert int(counts.max()) == 40 and pt_wide_cuda.row_nnz(J).equal(counts.int())


def test_the_10_seed_cdqbm_a_sweep_call_takes_k4_and_k5s_sparse_path():
    """The 10-seed CDQBM (a) sweep's step (``SeedParallelCDQBM.step_qubos``:
    G=20 groups of B=20 at n=717, every seed's clamped group then every
    unclamped one): K4 takes it at 32 chains a block on a grid of (63, 20)
    (40,000 chains, 1,260 blocks, one an SM); PT routes to K5, whose 20
    row lists, sized by the one host sync of the call, fit beside 4
    ladders a block: the sparse path on a grid of (500, 20) (320,000
    rungs, 10,000 blocks)."""
    from qbmx_torch.models.cdqbm import CDQBM
    from qbmx_torch.train.sweep import SeedParallelCDQBM

    donor = CDQBM(pooling_size=4, pooling_type="probabilistic", sequential_layer_sizes=[4],
                  hidden_bias_type="shared", solver="PT", beta_eff=5.0, device="cpu")
    sweep = SeedParallelCDQBM(range(10), donor)
    x = torch.as_tensor(np.random.default_rng(4).random((20, 28, 28), dtype=np.float32))
    Q, h = sweep.step_qubos(x, torch.arange(20) % 2)
    G, B, M, R, n = 20, 20, 8, 100, 717
    assert Q.shape == (G, n, n) and h.shape == (G, B, n)
    wide = wide_cuda.wide_geometry(G, B, R, n)
    assert (wide.chains_per_block, wide.grid) == (32, (63, 20))
    assert pt_wide_cuda.pt_route(G, B, M, R, n) == "pt_wide"
    J = split_qubo(Q)[1]
    counts = pt_wide_cuda.row_nnz(J)
    nnz = pt_wide_cuda.group_nnz(counts)
    assert len(nnz) == G and max(nnz) <= CDQBM_A_NNZ_PAD and int(counts.max()) <= 40
    rows = pt_wide_cuda.row_lists(J, counts, nnz)
    assert rows.vals.shape == (G, pt_wide_cuda.padded(max(nnz))) and rows.nnz == nnz
    geo = pt_wide_cuda.pt_wide_geometry(G, B, M, R, n, rows.nnz_pad)
    assert (geo.path, geo.ladders_per_block, geo.cluster, geo.threads, geo.grid) == \
        (pt_wide_cuda.SPARSE, 4, 1, 1024, (500, 20))
    assert geo.smem <= kernel_call.SMEM_BYTES


def test_rbm_cd1_bound_at_the_headline_shape():
    """The CD-1 bf16 epoch at batch 4096, 784 × 128 (16 steps): bound by its
    three f32 products, 0.60 ms; at H=9 by the same products, 0.042 ms
    (the bf16 batches' bytes, 0.031 ms, come close)."""
    b = roofline.rbm_cd1_bound(16, 4096, 784, 128)
    f32 = 16 * 3 * 2 * 4096 * (784 + 2) * 128
    assert b["bound_by"] == "operations" and b["flops"] == f32 + 16 * 2 * 4096 * 128 * 786
    assert b["bound_ms"] == pytest.approx(1e3 * (f32 / 67e12 + 16 * 2 * 4096 * 128 * 786 / 989e12))
    assert 0.59 < b["bound_ms"] < 0.62
    b9 = roofline.rbm_cd1_bound(16, 4096, 784, 9)
    assert b9["bound_by"] == "operations" and 0.04 < b9["bound_ms"] < 0.045
    assert 0.03 < 1e3 * b9["bytes"] / 3.35e12 < b9["bound_ms"]


@pytest.mark.parametrize("n", [1024, 1056, 1057, 1280, 1416, 1417, 2048, 2232, 2560, 2608, 2609,
                               3000, 3368])
def test_layout_rules_switch_where_a_block_holds_five(n):
    """K4's shared layout takes a call up to n = 1056, where a block holds
    31 chains, and K5's dense path up to n = 1416, where a block holds 20
    rungs (both 5 before the global layouts' redesign, at n = 2608); past
    them the global-field layout and the global path take it, at the
    CDQBM (a) call's 4,000 chains and 32,000 rungs.  K5's sparse path keeps
    its rule: J_g's row lists that fit a block beside its rungs."""
    assert (wide_cuda.switch_n(), pt_wide_cuda.switch_n()) == (1056, 1416)
    assert (wide_cuda.wide_geometry(2, 20, 100, n).layout == wide_cuda.SHARED) == (n <= 1056)
    assert (pt_wide_cuda.pt_wide_geometry(2, 20, 8, 100, n).path == pt_wide_cuda.DENSE) == \
        (n <= 1416)
    assert pt_wide_cuda.pt_wide_geometry(2, 20, 8, 100, n, 8).path == pt_wide_cuda.SPARSE
