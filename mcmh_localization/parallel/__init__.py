from mcmh_localization.parallel.sharding import (
    make_mesh,
    make_sharded_model,
    shard_state,
)

__all__ = ["make_mesh", "make_sharded_model", "shard_state"]
