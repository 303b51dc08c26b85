"""A cell cut to a size the CPU runs in seconds, for the harness's tests:
few images (the last batch partial), reads and sweeps, three seeds for a
sweep, and the CDQBM on 8×8 images (n = 48)."""

from __future__ import annotations

import copy


def tiny(cfg: dict, mix: dict):
    cfg, mix = copy.deepcopy(cfg), dict(mix)
    # a partial last batch, and one in the CDQBM's warm-up rows (3 x 8 + 46 % 8)
    cfg["data"].update(train=46, val=10)
    cfg["train"].update(sample_count=16, anneal=20, batch=8)
    if cfg["family"] == "cdqbm":
        cfg["data"]["image_shape"] = cfg["model"]["image_shape"] = [8, 8]
        cfg["model"].update(pooling_size=2, sequential_layer_sizes=[2])
        cfg["free_units"] = {"clamped": 36 + 9 + 2, "unclamped": 36 + 9 + 2 + 1}
    if mix["seeds"] > 1:
        mix["seeds"] = 3
    mix["trace_epochs"] = 1
    return cfg, mix
