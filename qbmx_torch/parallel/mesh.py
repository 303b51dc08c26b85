"""Multi-device training over ``torch.distributed`` — counterpart of
``qbmx.parallel.mesh``.

One process a rank.  A (dp, chains) mesh lays the first dp·chains ranks of
an initialised process group out row-major, rank = dp_idx·chains + ch_idx:

  * **dp** — data parallelism: a sharded step takes the whole batch and
    keeps its B/dp rows; a seed sweep trains its S/dp seeds.
  * **chains** — chain parallelism: each rank anneals ``reads/chains``
    reads a problem from a stream of its own.

A sharded step is the model's own ``_step`` through a rank's seams
(:class:`MeshSeams`: its rows, its stream, its reads, its reduction).  Its
one collective is an all-reduce of the masked moment sums, the mask count
and the nll sum (a few KB); every rank then applies the same gradient to
its replica of the parameters, so they stay equal without a broadcast.  The collectives are all-reduces only, the one
operation (with broadcast) that gloo runs on CUDA tensors: a gather is an
all-reduce of a zero-padded tensor.  So several ranks can share one card
over gloo, which NCCL refuses.

A rank's stream is ``core.rng.fold_in(model.generator, dp_idx, ch_idx)``:
one seed drawn from the model's generator on every rank (which leaves the
generators equal) folded with the rank's coordinates.  The single model's
``_step`` fed that stream gives a world of one's step bit for bit.

The sharded step never takes the restricted linear shortcut: both phases
are sampled as two structured groups, as in ``qbmx``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from qbmx_torch.core.rng import fold_in
from qbmx_torch.models import cdqbm as cdqbm_mod
from qbmx_torch.models import dqbm as dqbm_mod
from qbmx_torch.models.base import resolve_device, tree_leaves, tree_map
from qbmx_torch.models.dqbm import StepSeams


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A (dp, chains) layout of ranks, seen from one rank: ``coords`` is
    its ``(dp_idx, ch_idx)`` (None outside the mesh), ``group`` the
    dp·chains ranks, ``dp_group`` the dp ranks that share its ``ch_idx``
    (a seed sweep's axis), ``device`` where its tensors live."""

    dp: int
    chains: int
    rank: int
    device: torch.device
    coords: tuple[int, int] | None
    group: object
    dp_group: object

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "chains": self.chains}

    def member(self) -> tuple[int, int]:
        """This rank's ``(dp_idx, ch_idx)``; raises outside the mesh."""
        if self.coords is None:
            raise RuntimeError(f"rank {self.rank} is outside the {self.dp}x{self.chains} mesh")
        return self.coords

    def __deepcopy__(self, memo):
        return self  # a handle on process groups: copies of a model share it


def make_mesh(dp: int | None = None, chains: int = 1, device="cuda") -> Mesh:
    """Build a (dp, chains) mesh over the ranks of the initialised process
    group (the first dp·chains of them; ``dp`` defaults to world //
    chains).  Every rank of the group must call it, in the same order as
    its other group calls.

    ``device``: the card unless the caller asks for the CPU; ``"cuda"``
    means card ``rank % device_count``, one rank a card, as NCCL needs.
    Several ranks on one card (``"cuda:0"``) need a gloo group, and so does
    the CPU.  A card asked for where there is none raises."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs an initialised process group: call "
            "torch.distributed.init_process_group(backend, init_method=..., rank=..., "
            "world_size=...) in every rank first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if dp is None:
        dp = world // chains
    if dp < 1 or chains < 1 or dp * chains > world:
        raise ValueError(f"dp*chains = {dp}*{chains} does not fit {world} rank(s) "
                         "(each axis needs at least 1 rank)")
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if dist.get_backend() == "nccl" and dev.type != "cuda":
        raise ValueError("an NCCL group moves CUDA tensors only: pass a card as device, "
                         "or initialise a gloo group for the CPU")
    n = dp * chains
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    dp_groups = ([group] if chains == 1 else
                 [dist.new_group([d * chains + c for d in range(dp)]) for c in range(chains)])
    coords = divmod(rank, chains) if rank < n else None
    return Mesh(dp, chains, rank, dev, coords, group, dp_groups[coords[1]] if coords else None)


def writes_files(obj) -> bool:
    """Whether ``obj`` (a model or a sweep) writes its pickles, histories,
    checkpoints and figures: always without a mesh, on global rank 0 alone
    with one — every rank would otherwise write the same paths."""
    mesh = getattr(obj, "mesh", None)
    return mesh is None or mesh.rank == 0


# ---------------------------------------------------------------------------
# Seed sweeps: the rows a rank trains and their gather
# ---------------------------------------------------------------------------


def seed_rows(mesh: Mesh | None, S: int) -> range:
    """The seeds (by index) this rank trains: all S without a mesh, its dp
    block of S/dp with one."""
    if mesh is None:
        return range(S)
    if S % mesh.dp:
        raise ValueError(f"{S} seeds not divisible by dp={mesh.dp}")
    k = S // mesh.dp
    i = mesh.member()[0]
    return range(i * k, (i + 1) * k)


def gather_rows(mesh: Mesh, local: torch.Tensor, rows: range, total: int) -> torch.Tensor:
    """Every dp rank's rows of a stacked tensor, on every rank: ``local``
    (len(rows), ...) zero-padded to (total, ...) and summed over the dp
    group (x + 0 is x: the gather is exact)."""
    full = local.new_zeros((total,) + tuple(local.shape[1:]))
    full[rows.start: rows.stop] = local
    staged = full.to(mesh.device)
    dist.all_reduce(staged, group=mesh.dp_group)
    return staged.to(local.device)


def gather_tree(mesh: Mesh, tree, rows: range, total: int):
    """:func:`gather_rows` for every tensor of a stacked parameter tree."""
    return tree_map(lambda leaf: gather_rows(mesh, leaf, rows, total), tree)


def gather_numpy(mesh: Mesh, local: np.ndarray, rows: range, total: int) -> np.ndarray:
    """:func:`gather_rows` for a host array (float64 or int64)."""
    return gather_rows(mesh, torch.from_numpy(np.ascontiguousarray(local)), rows, total).numpy()


# ---------------------------------------------------------------------------
# Sharded steps
# ---------------------------------------------------------------------------


def _dp_rows(mesh: Mesh, *tensors):
    """This rank's B/dp rows of each batch tensor (the batch must divide)."""
    B = tensors[0].shape[0]
    if B % mesh.dp:
        raise ValueError(f"batch of {B} rows does not divide over dp={mesh.dp}")
    k = B // mesh.dp
    i = mesh.member()[0]
    return [t[i * k: (i + 1) * k] for t in tensors]


def _reduce(mesh: Mesh, diff, mask, probs, y):
    """The step's one collective: the masked sums of the per-example moment
    differences, the mask count and the nll sum, summed over the mesh.
    Returns ``(grad, nll)``: the sums and the nll over ``max(count, 1)``,
    the count being Σ mask · chains."""
    m = lambda leaf: mask.reshape((-1,) + (1,) * (leaf.dim() - 1))
    sums = tree_map(lambda leaf: (leaf * m(leaf)).sum(dim=0), diff)
    pick = torch.gather(probs, 1, y[:, None].to(torch.int64))[:, 0]
    nll_sum = (-torch.log(pick + 1e-12) * mask).sum()
    leaves = tree_leaves(sums)
    flat = torch.cat([leaf.reshape(-1) for leaf in leaves]
                     + [mask.sum().reshape(1), nll_sum.reshape(1)])
    dist.all_reduce(flat, group=mesh.group)
    parts = iter(torch.split(flat, [leaf.numel() for leaf in leaves] + [1, 1]))
    summed = tree_map(lambda leaf: next(parts).view_as(leaf), sums)
    denom = torch.clamp(next(parts)[0], min=1.0)
    return tree_map(lambda s: s / denom, summed), next(parts)[0] / denom


def check_device(device: torch.device, mesh: Mesh) -> None:
    """Raise unless ``device`` (a card without an index: the current one)
    is the mesh's."""
    dev = device
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev != mesh.device:
        raise ValueError(f"tensors on {device}, but the mesh is on {mesh.device}")


class MeshSeams(StepSeams):
    """A rank's seams of a training step (``DiscQBM._step``,
    ``CDQBM._step``): its B/dp rows of the batch, the stream
    ``fold_in(model.generator, dp_idx, ch_idx)``, ``reads // chains`` reads
    a problem (at least 1), and the masked sums all-reduced over the mesh
    (:func:`_reduce`); never the linear shortcut."""

    shortcut = False

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.coords = mesh.member()

    def rows(self, *tensors):
        return _dp_rows(self.mesh, *tensors)

    def generator(self, model) -> torch.Generator:
        return fold_in(model.generator, *self.coords)

    def reads(self, count: int) -> int:
        return max(count // self.mesh.chains, 1)

    def reduce(self, diff, mask, probs, y):
        return _reduce(self.mesh, diff, mask, probs, y)


def _sharded_step(model, mesh: Mesh, family: type):
    if not isinstance(model, family):
        raise TypeError(f"expected a {family.__name__}, got {type(model)!r}")
    check_device(model.device, mesh)
    seams = MeshSeams(mesh)
    return lambda x, y, mask, lr: model._step(x, y, mask, lr, seams)


def make_dqbm_sharded_step(model: "dqbm_mod.DiscQBM", mesh: Mesh):
    """Sharded training step for the flat Disc_QBM, with ``DiscQBM._step``'s
    signature: ``(x, y, mask, lr) -> (nll, err)``, updating
    ``model.params`` in place: the model's own step through a rank's
    :class:`MeshSeams` (one structured sampler call of two groups,
    ``DiscQBM.step_qubos``)."""
    return _sharded_step(model, mesh, dqbm_mod.DiscQBM)


def make_cdqbm_sharded_step(model: "cdqbm_mod.CDQBM", mesh: Mesh):
    """Sharded training step for the CDQBM — the same (dp, chains) layout
    and signature, over ``CDQBM.step_qubos`` and its moments."""
    return _sharded_step(model, mesh, cdqbm_mod.CDQBM)


def shard_model(model, mesh: Mesh):
    """Give the model a rank's step, in place (``model.step_seams``:
    :class:`MeshSeams`); ``train.loop.train_model`` then trains it
    unchanged (the batch must divide over dp).  The model keeps its
    ``use_linear_shortcut`` and its ``_sampler_call_groups`` probe reports
    the two groups the sharded step samples.  Prediction stays replicated:
    every rank runs it whole on the same stream.  Only global rank 0 writes
    files (:func:`writes_files`).

    The QPU adapters (``jit_safe = False``, a network roundtrip a problem)
    are refused, as ``qbmx`` refuses them; ``SA-NATIVE`` is taken, as the
    seed sweeps take it."""
    if not getattr(model.sampler, "jit_safe", True):
        raise TypeError("sharded steps run the sampler inside every rank's step; the "
                        "model's sampler declares jit_safe=False (host-bound)")
    if not isinstance(model, (dqbm_mod.DiscQBM, cdqbm_mod.CDQBM)):
        raise TypeError(f"no sharded step for {type(model)!r}")
    check_device(model.device, mesh)
    model.step_seams = MeshSeams(mesh)
    model.mesh = mesh
    return model
