"""Multi-rank registration and pose-graph optimisation on ``torch.distributed``:
the counterpart of ``dicp_tpu.parallel``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with the dims
``("batch", "map")`` (:func:`make_mesh`; :mod:`.multihost` for jobs of
several processes).  The entry points are SPMD: every rank calls them with
the same global arguments.  Every collective goes through :mod:`._comm`,
which counts them.
"""

from dicp_tpu_torch.parallel.sharding import (
    make_mesh,
    shard_batch,
    register_batch_sharded,
    register_map_sharded,
    register_ring_sharded,
    ring_nn,
    MapShardedResult,
)
from dicp_tpu_torch.parallel.ift_sharded import register_map_sharded_ift
from dicp_tpu_torch.parallel.pose_graph import (
    partition_graph,
    pose_graph_optimize_partitioned,
)

__all__ = [
    "make_mesh",
    "shard_batch",
    "register_batch_sharded",
    "register_map_sharded",
    "register_map_sharded_ift",
    "register_ring_sharded",
    "ring_nn",
    "MapShardedResult",
    "partition_graph",
    "pose_graph_optimize_partitioned",
]
