from qbmx_torch.parallel.mesh import (
    make_cdqbm_sharded_step,
    make_dqbm_sharded_step,
    make_mesh,
    shard_model,
)

__all__ = [
    "make_mesh",
    "make_dqbm_sharded_step",
    "make_cdqbm_sharded_step",
    "shard_model",
]
