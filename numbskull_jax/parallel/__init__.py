"""Multi-device parallelism: chain replication and graph sharding."""

from numbskull_jax.parallel.mesh import make_mesh  # noqa: F401
from numbskull_jax.parallel.partition import (  # noqa: F401
    balanced_partition, choose_partition, connected_components, edge_cut,
    make_part_plans, partition_cost,
)


def __getattr__(name):
    # lazy: sharded/bsp import jax-heavy modules
    if name in ("ShardedGibbsEngine", "ShardedState"):
        from numbskull_jax.parallel import sharded
        return getattr(sharded, name)
    if name == "BSPEngine":
        from numbskull_jax.parallel import bsp
        return getattr(bsp, name)
    raise AttributeError(name)
