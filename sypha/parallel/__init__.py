from sypha.parallel.distributed import (
    BoundPool,
    initialize_distributed,
)
from sypha.parallel.mesh import (
    make_mesh,
    pooled_stats,
    shard_batch,
    shard_shared_batch,
    solve_lp_batch_sharded,
    solve_shared_batch_sharded,
    solve_shared_batch_tensor_parallel,
)

__all__ = [
    "BoundPool",
    "initialize_distributed",
    "make_mesh",
    "pooled_stats",
    "shard_batch",
    "shard_shared_batch",
    "solve_lp_batch_sharded",
    "solve_shared_batch_sharded",
    "solve_shared_batch_tensor_parallel",
]
