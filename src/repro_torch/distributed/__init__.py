"""Distribution layer: the sharded window-analytics streaming runtime over
``torch.distributed`` (:mod:`.window_runtime`)."""

from repro_torch.distributed.window_runtime import (  # noqa: F401
    ShardedDBPlan,
    ShardedSession,
    ShardedStreamState,
    build_sharded_plan,
    patch_sharded_plan,
    query_sharded_multi,
)
