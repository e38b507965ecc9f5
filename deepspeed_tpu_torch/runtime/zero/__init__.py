from .partitioning import (
    DEFAULT_LOGICAL_RULES,
    ZeroShardingPolicy,
    add_zero_axis,
    gather_full,
    init_partitioned,
    logical_to_spec,
    shard_of,
    zero_dim,
)
from .tiling import TiledLinear, init_tiled_linear, split_dim, tiled_linear
