"""The convolutional deep QBM: ``CDQBM`` trained by ``train_model`` (entry
``single``) or ``SeedParallelCDQBM`` by its ``train`` (entry ``sweep``)."""

from __future__ import annotations

import inspect

from benchmark import data as bdata
from benchmark import registry
from benchmark.cell import Cell
from benchmark.families import common
from qbmx_torch.models.cdqbm import CDQBM, CDQBMParams
from qbmx_torch.train.sweep import SeedParallelCDQBM

ARRAYS = ("kernel", "w_h2o", "w_oo", "b_conv", "b_seq", "b_o")


def to_dict(p: CDQBMParams, lead: bool) -> dict:
    """A (stacked, or with ``lead`` a single model's) ``CDQBMParams`` as the
    harness's dict with a leading seed axis."""
    f = (lambda a: a[None]) if lead else (lambda a: a)
    d = {k: f(getattr(p, k)) for k in ARRAYS}
    for i, (w, wi) in enumerate(zip(p.w_seq, p.w_seq_intra)):
        d[f"w_seq.{i}"], d[f"w_seq_intra.{i}"] = f(w), f(wi)
    return d


def from_dict(d: dict, layers: int, single: bool) -> CDQBMParams:
    f = (lambda a: a[0].clone()) if single else (lambda a: a.clone())
    return CDQBMParams(**{k: f(d[k]) for k in ARRAYS},
                       w_seq=tuple(f(d[f"w_seq.{i}"]) for i in range(layers)),
                       w_seq_intra=tuple(f(d[f"w_seq_intra.{i}"]) for i in range(layers)),
                       pen=None)


def build(cfg: dict, mix: dict, seed: int, data: dict, weights: dict, device) -> Cell:
    m, t = cfg["model"], registry.settings(cfg, mix)
    seeds = common.seed_list(seed, mix["seeds"])
    parts = bdata.splits(data, t)
    layers = len(m["sequential_layer_sizes"])
    model = CDQBM(seed=seeds[0], solver=mix["solver"], anneal=t["anneal"],
                  sample_count=t["sample_count"], device=device,
                  **{**m, "image_shape": tuple(m["image_shape"])})
    images = cfg["data"]["train"] * len(seeds)
    if mix["entry"] == "single":
        chunk = inspect.signature(CDQBM.predict_batch).parameters["chunk"].default
        if t["predict_chunk"] != chunk:
            raise ValueError(f"train_model validates a CDQBM in chunks of {chunk}, "
                             f"not {t['predict_chunk']}")

        def set_params(d):
            model.params = from_dict(d, layers, single=True)

        set_params(weights)
        return Cell(owner=model, sampler_host=model, predict_host=model,
                    predict_name="predict_batch",
                    epoch=common.single_epoch(model, t, parts),
                    params=lambda: to_dict(model.params, lead=True),
                    set_params=set_params, seeds=1, images_per_epoch=images)
    if mix["entry"] != "sweep":
        raise ValueError(f"unknown entry {mix['entry']!r}")
    sweep = SeedParallelCDQBM(seeds, model)

    def set_sweep(d):
        sweep.params = from_dict(d, layers, single=False)

    set_sweep(weights)
    return Cell(owner=sweep, sampler_host=model, predict_host=sweep, predict_name="_validate",
                epoch=common.sweep_epoch(sweep, t, parts, predict_chunk=t["predict_chunk"]),
                params=lambda: to_dict(sweep.params, lead=False),
                set_params=set_sweep, seeds=len(seeds), images_per_epoch=images)

