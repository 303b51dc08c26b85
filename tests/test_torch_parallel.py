"""qbmx_torch.parallel.mesh (the mesh over torch.distributed) against
qbmx.parallel.mesh and against the port's own single-device code, on the
CPU over gloo.

Most checks run in ONE spawned world of four ranks
(``qbmx_torch.parallel.dryrun.spawn``: a ``file://`` rendezvous under
``tmp_path``, a join timeout and a process-group timeout, so a hung
collective fails the tests instead of the suite's clock), each rank running
the same list of scenarios from ``qbmx_torch/parallel/dryrun.py`` and
``tests/torch_mesh_scenarios.py`` (which import no jax: the ranks never
do) and returning numpy results that the tests below read.  ``qbmx``'s tests use 8 virtual devices; four ranks stand
in for them here ((dp, chains) = (2, 2) for (4, 2), dp=4 for dp=8).  They
mirror ``tests/test_parallel.py``, ``tests/test_sweep.py``'s mesh tests,
``tests/test_dqbm.py::test_full_mnist_shapes_on_mesh`` and
``tests/test_qpu_adapter.py::test_shard_model_rejects_host_bound_sampler``
with ``qbmx``'s tolerances: a sharded step within 0.05 (nll 0.2) of the
single-device step under the exact sampler at 4096 reads, the seed-sharded
DQBM sweep within 1e-5 of the unsharded one with equal accuracy lists, the
RBM sweep bit for bit.  Beyond those: the port's sharded step against
``qbmx``'s from the same parameters; a world of one (a gloo group in this
process) gives the single step fed the same stream bit for bit, and the
sweeps at dp=1 are the unsharded sweeps bit for bit; only rank 0 writes
files; the dryrun runs in a process that imports no jax and no ``qbmx``.

Not ported: ``tests/test_parallel.py:124``, ``:163-221`` and ``:328``,
which test the TPU's epoch-scan routing and the lane kernel under
``shard_map``.
"""

from __future__ import annotations

import copy
import datetime
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch_mesh_scenarios as scenarios
from qbmx.models.dqbm import DiscQBM as JDiscQBM
from qbmx.parallel.mesh import make_dqbm_sharded_step as j_sharded_step
from qbmx.parallel.mesh import make_mesh as j_make_mesh
from qbmx.samplers.api import ExactSampler as JExactSampler
from qbmx_torch.core.rng import RowStream, draw_seed, fold_in, make_generator
from qbmx_torch.models import rbm as trbm
from qbmx_torch.models.base import tree_leaves
from qbmx_torch.models.dqbm import FIELDS, SINGLE_DEVICE, DiscQBM, params_to_numpy
from qbmx_torch.parallel import dryrun
from qbmx_torch.parallel.mesh import make_mesh, shard_model
from qbmx_torch.samplers.api import GibbsSampler, SASampler, get_sampler
from qbmx_torch.samplers.qpu import QPUSampler
from qbmx_torch.train.sweep import SeedParallelDQBM, SeedParallelRBM

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
WORLD = 4
STEP_ATOL, NLL_ATOL, SWEEP_ATOL = dryrun.STEP_ATOL, dryrun.NLL_ATOL, dryrun.SWEEP_ATOL


def _qbmx_model():
    """qbmx's model of ``test_sharded_matches_single_device_with_exact_sampler``."""
    return JDiscQBM(dim_input=4, n_hidden_nodes=2, seed=0, sample_count=4096,
                    restricted=False, sampler=JExactSampler())


def _qbmx_fields(p) -> dict:
    return {k: np.asarray(getattr(p, k), np.float32) for k in FIELDS}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every scenario's result on each of the four ranks, by key."""
    root = tmp_path_factory.mktemp("ranks")
    calls = {
        "shapes": ("mesh_shapes", {}),
        "dqbm_runs": ("step_runs", {"family": "dqbm"}),
        "cdqbm_runs": ("step_runs", {"family": "cdqbm"}),
        "dqbm784": ("step_runs", {"family": "dqbm784"}),
        "exact": ("step_against_single",
                  {"dp": 4, "chains": 1, "family": "dqbm",
                   "init": _qbmx_fields(_qbmx_model().params)}),
        "masked": ("masked_tail", {}),
        "clip": ("grad_clip", {}),
        "shard_model": ("shard_model_trains", {}),
        "rbm": ("rbm_sweeps", {"dp": 4}),
        "rbm_hybrid": ("rbm_sweeps", {"dp": 4, "method": "hybrid", "epochs": 2}),
        "dqbm_sweep": ("dqbm_sweeps", {"dp": 4}),
        "reinit": ("dqbm_sweeps", {"dp": 4, "seeds": 4, "epochs": 1, "reinit": (1, 3)}),
        "cdqbm_sweep": ("cdqbm_sweeps", {"dp": 4}),
        "refusals": ("refusals", {}),
        "writes": ("writes", {"root": str(root)}),
    }
    ranks = dryrun.spawn(scenarios.run_all, WORLD, "gloo", ("cpu", list(calls.values())),
                         timeout=240.0)
    return {key: [r[i] for r in ranks] for i, key in enumerate(calls)}


@pytest.fixture
def world1(tmp_path):
    """A gloo group of one rank in this process, and its 1x1 CPU mesh."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        yield make_mesh(dp=1, chains=1, device="cpu")
    finally:
        dist.destroy_process_group()


# -- the mesh ------------------------------------------------------------------


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh(dp=1, device="cpu")


def test_make_mesh_shapes(world):
    for rank, r in enumerate(world["shapes"]):
        assert r["2x2"] == {"dp": 2, "chains": 2}
        assert r["chains=2"]["dp"] == 2
        assert r["coords"] == divmod(rank, 2)  # row-major: rank = dp_idx * chains + ch_idx


def test_bad_factorization(world, world1):
    for r in world["shapes"]:
        assert "does not fit 4 rank" in r["dp=3"] and "does not fit" in r["dp=5"]
    with pytest.raises(ValueError):
        make_mesh(dp=5, chains=2, device="cpu")


def test_make_mesh_refuses_a_card_that_is_not_there(world1, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(dp=1, device="cuda")


# -- the sharded steps -----------------------------------------------------------


def test_dqbm_step_runs_and_updates(world):
    for r in world["dqbm_runs"]:
        assert np.isfinite(r["nll"])
        assert any(not np.allclose(a, b) for a, b in zip(r["after"], r["before"]))
    # the parameters stay replicated: every rank applied the same gradient
    for r in world["dqbm_runs"][1:]:
        for a, b in zip(r["after"], world["dqbm_runs"][0]["after"]):
            np.testing.assert_array_equal(a, b)


def test_sharded_matches_single_device_with_exact_sampler(world):
    for r in world["exact"]:
        for a, b in zip(r["sharded"][0], r["single"][0]):
            assert np.allclose(a, b, atol=STEP_ATOL)
        assert abs(r["sharded"][1] - r["single"][1]) < NLL_ATOL


def test_port_sharded_step_matches_qbmx_sharded_step(world):
    """qbmx's sharded step on its virtual mesh (dp=4) and the port's on four
    gloo ranks, from qbmx's parameters, on the same batch."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    model = _qbmx_model()
    x, y = dryrun.toy_batch(1, 16, (4,))
    step = j_sharded_step(model, j_make_mesh(dp=4, chains=1))
    new, nll, _ = step(model.params, jnp.asarray(x.numpy()), jnp.asarray(y.numpy()),
                       jnp.ones((16,), jnp.float32), 0.5, jax.random.key(2))
    want = _qbmx_fields(new)
    for r in world["exact"]:
        got = dict(zip(FIELDS, r["sharded"][0]))
        for k in FIELDS:
            assert np.allclose(got[k], want[k], atol=STEP_ATOL), k
        assert abs(r["sharded"][1] - float(nll)) < NLL_ATOL
    assert all(np.array_equal(a, want0) for a, want0 in
               zip(world["exact"][0]["init"], _qbmx_fields(_qbmx_model().params).values()))


def test_masked_padding_sharded(world):
    for clean, poisoned in world["masked"]:
        for a, b in zip(clean, poisoned):
            assert np.allclose(a, b, atol=0.06)


def test_cdqbm_step_runs(world):
    for r in world["cdqbm_runs"]:
        assert np.isfinite(r["nll"])
        assert any(not np.allclose(a, b) for a, b in zip(r["after"], r["before"]))


def test_shard_model_trains_through_loop(world):
    for r in world["shard_model"]:
        assert len(r["nll_per_epoch"]) == 2 and np.all(np.isfinite(r["nll_per_epoch"]))
        assert len(r["acc_per_epoch"]) == 2
    for r in world["shard_model"][1:]:
        for a, b in zip(r["params"], world["shard_model"][0]["params"]):
            np.testing.assert_array_equal(a, b)


def test_full_mnist_shapes_on_mesh(world):
    for r in world["dqbm784"]:
        assert np.isfinite(r["nll"])
        assert r["after"][0].shape == (785, 8)


def test_grad_clip_applied_in_sharded_step(world):
    for r in world["clip"]:
        assert r[0.0] > 10 * 1e-3  # the toy gradient is far above the clip
        assert r[1e-3] <= 1e-3 * 1.01  # lr=1.0: update norm == clipped grad norm


def test_batch_must_divide_over_dp(world):
    for r in world["refusals"]:
        assert "does not divide over dp=4" in r["batch"]


def test_linear_shortcut_flag_survives_sharding(world1):
    model = DiscQBM(dim_input=4, n_hidden_nodes=2, restricted=True, use_linear_shortcut=True,
                    sample_count=16, sampler=GibbsSampler(num_warmup=4), device="cpu")
    assert model.use_linear_shortcut and model._sampler_call_groups() == 1
    shard_model(model, world1)
    assert model.use_linear_shortcut  # configuration intact
    assert model._sampler_call_groups() == 2  # the probe reflects the step


def test_shard_model_rejects_host_bound_sampler(world1):
    m = DiscQBM(dim_input=3, n_hidden_nodes=2, seed=0, sample_count=4,
                sampler=QPUSampler(object()), device="cpu")
    with pytest.raises(TypeError, match="jit_safe"):
        shard_model(m, world1)


def _dqbm(solver):
    return DiscQBM(dim_input=6, n_hidden_nodes=3, seed=0, sample_count=16, device="cpu",
                   sampler=get_sampler(solver, num_sweeps=5))


def _cdqbm(solver):
    return dryrun.cdqbm_model("cpu", sample_count=8, sampler=get_sampler(solver, num_sweeps=4),
                              image_shape=(6, 6), pooling_size=2,
                              pooling_type="deterministic", sequential_layer_sizes=[3])


@pytest.mark.parametrize("family,solver", [("dqbm", "SA"), ("dqbm", "BMS"), ("dqbm", "PT"),
                                           ("dqbm", "EXACT"), ("cdqbm", "SA"),
                                           ("cdqbm", "BMS")])
def test_world_of_one_is_the_single_step_bit_for_bit(world1, family, solver):
    """At a world of one the sharded step is the single model's ``_step``
    fed ``fold_in(generator, 0, 0)``: parameters, nll and err bit for bit."""
    model = _dqbm(solver) if family == "dqbm" else _cdqbm(solver)
    shape = (6,) if family == "dqbm" else (6, 6)
    x, y = dryrun.toy_batch(11, 8, shape)
    mask = torch.tensor([1, 1, 1, 1, 1, 1, 1, 0], dtype=torch.float32)
    single = copy.deepcopy(model)
    single.generator = fold_in(single.generator, 0, 0)
    n1, e1 = single._step(x, y, mask, 0.3)
    n2, e2 = shard_model(model, world1)._step(x, y, mask, 0.3)
    assert torch.equal(n1, n2) and torch.equal(e1, e2)
    for a, b in zip(tree_leaves(single.params), tree_leaves(model.params)):
        assert torch.equal(a, b)
    # the model's own generator is where one draw leaves it, on every rank
    fresh = _dqbm(solver) if family == "dqbm" else _cdqbm(solver)
    fold_in(fresh.generator, 5, 7)
    assert torch.equal(model.generator.get_state(), fresh.generator.get_state())


def test_make_sharded_step_is_the_models_step_through_a_ranks_seams(world1):
    """``make_dqbm_sharded_step`` / ``make_cdqbm_sharded_step`` run the model's
    own ``_step`` through ``MeshSeams`` without installing them: the same
    update as ``shard_model``'s, the model's ``step_seams`` left single; each
    refuses the other family."""
    from qbmx_torch.parallel.mesh import make_cdqbm_sharded_step, make_dqbm_sharded_step

    for model, make, other, shape in ((_dqbm("SA"), make_dqbm_sharded_step,
                                       make_cdqbm_sharded_step, (6,)),
                                      (_cdqbm("SA"), make_cdqbm_sharded_step,
                                       make_dqbm_sharded_step, (6, 6))):
        x, y = dryrun.toy_batch(12, 8, shape)
        mask = torch.ones(8)
        installed = shard_model(copy.deepcopy(model), world1)
        n1, _ = installed._step(x, y, mask, 0.3)
        n2, _ = make(model, world1)(x, y, mask, 0.3)
        assert torch.equal(n1, n2) and model.step_seams is SINGLE_DEVICE
        for a, b in zip(tree_leaves(installed.params), tree_leaves(model.params)):
            assert torch.equal(a, b)
        with pytest.raises(TypeError, match="expected a"):
            other(model, world1)


def test_row_streams_launch_seeds_differ_by_rank_and_leave_the_generator_equal():
    """A kernel's launch seed from a rank's ``RowStream``: the seed the whole
    call draws, folded with the rank's first row, so ranks that launch the
    same local groups anneal from different numbers; every rank leaves the
    sweep's generator where the whole call leaves it, and a stream holding
    the whole call launches with the whole call's seed."""
    S, dp = 8, 2
    rows = [[ph * S + s for ph in range(2) for s in range(r * S // dp, (r + 1) * S // dp)]
            for r in range(dp)]
    gens = [make_generator(5) for _ in range(dp + 2)]
    seeds = [draw_seed(RowStream(g, rows[r], 2 * S)) for r, g in enumerate(gens[:dp])]
    whole = draw_seed(RowStream(gens[dp], range(2 * S), 2 * S))
    plain = draw_seed(gens[dp + 1])
    assert seeds[0] != seeds[1] and plain not in seeds
    assert whole == plain
    assert all(0 <= v < 2**63 for v in seeds)
    for g in gens[1:]:
        assert torch.equal(g.get_state(), gens[0].get_state())


# -- the seed sweeps -------------------------------------------------------------


def test_seed_axis_shards_over_dp_mesh(world):
    """Seed-sharded sweep on four ranks reproduces the unsharded run."""
    for r in world["dqbm_sweep"]:
        (acc_s, p_s, best_s, _, nll_s), (acc_u, p_u, best_u, _, nll_u) = \
            r["sharded"], r["unsharded"]
        for k in FIELDS:
            assert np.allclose(p_s[k], p_u[k], atol=SWEEP_ATOL)
        for s in range(8):
            assert acc_s[s] == pytest.approx(acc_u[s])
        assert best_s == best_u
        np.testing.assert_allclose(nll_s, nll_u, atol=SWEEP_ATOL)


def test_mesh_requires_divisible_seed_count(world):
    for r in world["refusals"]:
        assert "not divisible by dp=2" in r["dqbm_sweep"]


def test_reinit_seeds_under_dp_mesh(world):
    """``reinit_seeds`` on a sharded sweep equals the unsharded re-draw, and
    the re-drawn state trains."""
    for r in world["reinit"]:
        for k in FIELDS:
            np.testing.assert_array_equal(r["sharded"][3][k], r["unsharded"][3][k])
        assert all(len(a) == 1 for a in r["sharded"][0])


@pytest.mark.parametrize("key", ["rbm", "rbm_hybrid"])
def test_rbm_sweep_mesh_matches_unsharded_bitwise(world, key):
    """Per-seed metrics, best epochs and final parameters bit for bit; the
    hybrid method's CD chain draws its numbers through the rank's rows."""
    for r in world[key]:
        (acc_s, auc_s, p_s, best_s), (acc_u, auc_u, p_u, best_u) = r["sharded"], r["unsharded"]
        assert acc_s == acc_u and auc_s == auc_u and best_s == best_u
        for a, b in zip(p_s, p_u):
            np.testing.assert_array_equal(a, b)


def test_rbm_sweep_mesh_divisibility(world):
    for r in world["refusals"]:
        assert "not divisible by dp=4" in r["rbm_sweep"]


def test_cdqbm_sweep_mesh_matches_unsharded(world):
    for r in world["cdqbm_sweep"]:
        (acc_s, p_s), (acc_u, p_u) = r["sharded"], r["unsharded"]
        assert acc_s == acc_u
        assert dryrun._tree_diff(p_s, p_u) <= SWEEP_ATOL


@pytest.mark.parametrize("family", ["dqbm", "rbm"])
def test_sweeps_at_dp_1_are_the_unsharded_sweeps_bit_for_bit(world1, family):
    rng = np.random.default_rng(8)
    x = rng.uniform(0, 1, (20, 6)).astype("float32")
    y = (x[:, 1] > 0.5).astype("float32")
    out = []
    for mesh in (world1, None):
        if family == "dqbm":
            sw = SeedParallelDQBM([4, 5, 6], dim_input=6, n_hidden_nodes=2, sample_count=8,
                                  device="cpu", mesh=mesh,
                                  sampler=SASampler(num_sweeps=4, use_kernel=False))
            hs = sw.train(x, y, x, y, epochs=2, batch_size=8, learning_rate=0.2,
                          verbose=False)
            out.append(([h.nll_per_batch for h in hs], list(params_to_numpy(sw.params).values())))
        else:
            sw = SeedParallelRBM([4, 5, 6], 6, 3, method="hybrid", generative_factor=0.5,
                                 device="cpu", mesh=mesh)
            acc, _ = sw.sweep(x, y.astype(int), x, y.astype(int), epochs=2, batch_size=5)
            out.append((acc, list(trbm.params_to_numpy(sw.params).values())))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        np.testing.assert_array_equal(a, b)


# -- files and imports -------------------------------------------------------------


def test_only_rank_0_writes_files(world):
    """Every rank is pointed at a folder of its own: rank 0's holds the
    sharded model's weight pickles, per-epoch series, checkpoint and the
    sweep's best-model pickles; the others' hold nothing."""
    by_rank = {r["rank"]: r["files"] for r in world["writes"]}
    files = by_rank[0]
    assert "model/e1.pkl" in files and "model/state.npz" in files
    assert "model/acc_per_epoch0.pkl" in files and "model/auc_per_epoch0.pkl" in files
    assert sum(f.startswith("sweep/best_model/") for f in files) == 4
    assert all(by_rank[r] == [] for r in range(1, WORLD))
    # every rank knows every seed's path
    assert all(sorted(r["paths"]) == [0, 1, 2, 3] for r in world["writes"])


def test_mesh_dryrun_and_synthesize_import_neither_jax_nor_qbmx(tmp_path):
    """``python -m qbmx_torch.parallel.dryrun`` at a world of two on the CPU
    (its ranks assert that they loaded no jax and no ``qbmx``) and the data
    synthesizer run in a process that loads neither."""
    code = (
        "import sys\n"
        "from qbmx_torch.data import synthesize\n"
        "from qbmx_torch.parallel import dryrun, mesh\n"
        "synthesize.synthesize_fashionmnist(sys.argv[1], max_train=20, max_test=10)\n"
        "dryrun.main(['--world', '2', '--device', 'cpu', '--timeout', '240'])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'qbmx'))\n"
        "print('LOADED', bad)\n"
    )
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True,
                         text=True, cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT)},
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert "every check passed" in res.stdout and "LOADED []" in res.stdout
