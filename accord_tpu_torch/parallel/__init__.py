"""Mesh construction and the sharded protocol kernels, in PyTorch."""

from .sharded import (STORE_AXIS, Mesh, make_mesh, shard_bucket_table,
                      shard_table, sharded_bucketed_flat,
                      sharded_calculate_deps,
                      sharded_calculate_deps_flat_pruned, sharded_drain,
                      sharded_protocol_step)

__all__ = ["STORE_AXIS", "Mesh", "make_mesh", "shard_bucket_table",
           "shard_table", "sharded_bucketed_flat", "sharded_calculate_deps",
           "sharded_calculate_deps_flat_pruned", "sharded_drain",
           "sharded_protocol_step"]
