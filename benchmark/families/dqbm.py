"""The flat Disc_QBM: ``DiscQBM`` trained by ``train_model`` (entry
``single``) or ``SeedParallelDQBM`` by its ``train`` (entry ``sweep``)."""

from __future__ import annotations

from benchmark import data as bdata
from benchmark import registry
from benchmark.cell import Cell
from benchmark.families import common
from qbmx_torch.models.dqbm import DiscQBM, DQBMParams
from qbmx_torch.train.sweep import SeedParallelDQBM

FIELDS = ("w_vh", "w_vo", "w_oo", "b_h", "b_o", "w_hh")


def build(cfg: dict, mix: dict, seed: int, data: dict, weights: dict, device) -> Cell:
    m, t = cfg["model"], registry.settings(cfg, mix)
    seeds = common.seed_list(seed, mix["seeds"])
    parts = bdata.splits(data, t)
    kw = dict(dim_input=m["dim_input"], num_classes=m["num_classes"],
              n_hidden_nodes=m["n_hidden_nodes"], restricted=m["restricted"],
              sample_count=t["sample_count"], anneal_steps=t["anneal"], beta_eff=m["beta_eff"],
              use_one_hot_encoding=m["use_one_hot_encoding"], solver=mix["solver"],
              device=device)
    images = cfg["data"]["train"] * len(seeds)
    if mix["entry"] == "single":
        model = DiscQBM(seed=seeds[0], **kw)

        def set_params(d):
            model.params = DQBMParams(**{k: d[k][0].clone() for k in FIELDS})

        set_params(weights)
        return Cell(owner=model, sampler_host=model, predict_host=model,
                    predict_name="predict_batch",
                    epoch=common.single_epoch(model, t, parts),
                    params=lambda: {k: getattr(model.params, k)[None] for k in FIELDS},
                    set_params=set_params, seeds=1, images_per_epoch=images)
    if mix["entry"] != "sweep":
        raise ValueError(f"unknown entry {mix['entry']!r}")
    sweep = SeedParallelDQBM(seeds, **kw)

    def set_sweep(d):
        sweep.params = DQBMParams(**{k: d[k].clone() for k in FIELDS})

    set_sweep(weights)
    return Cell(owner=sweep, sampler_host=sweep, predict_host=sweep, predict_name="_validate",
                epoch=common.sweep_epoch(sweep, t, parts),
                params=lambda: {k: getattr(sweep.params, k) for k in FIELDS},
                set_params=set_sweep, seeds=len(seeds), images_per_epoch=images)

