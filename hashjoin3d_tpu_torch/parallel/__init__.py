"""Multi-device joins: device meshes, hash-partition exchanges,
distributed joins.

Port of ``hashjoin3d_tpu/parallel``.  The JAX layer is SPMD through
``shard_map`` with ``all_to_all`` / ``psum`` / ``all_gather`` /
``ppermute`` over a mesh axis; here the same SPMD shape is one process a
rank on ``torch.distributed`` (NCCL on GPUs, gloo on the CPU), a
``DeviceMesh`` naming the axes, and each entry point a plain callable
``step(local columns) -> dict`` that every rank of the mesh calls.
``make_mesh`` on one card starts a 1-rank NCCL group by itself.
"""

from .mesh import make_mesh, shard_axis
from .shuffle import shard_of_key, partition_exchange
from .dist_join import dist_nested_join, dist_chaining_join
from .hier import dist_nested_join_2d, make_mesh_2d
from .dist_join import dist_nested_join_chunked
from .ring import dist_ring_nested_join
from .skew import (detect_skew, dist_broadcast_join, dist_hybrid_nested_join,
                   suggest_capacity)
from .pipeline import dist_filter_join_aggregate
from .multi import dist_deferred_two_join

__all__ = [
    "make_mesh", "shard_axis",
    "shard_of_key", "partition_exchange",
    "dist_nested_join", "dist_chaining_join",
    "dist_nested_join_2d", "make_mesh_2d",
    "dist_nested_join_chunked",
    "dist_ring_nested_join",
    "detect_skew", "dist_broadcast_join", "dist_hybrid_nested_join",
    "suggest_capacity",
    "dist_filter_join_aggregate",
    "dist_deferred_two_join",
]
