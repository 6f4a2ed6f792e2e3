"""Data parallelism over processes, and parameter sharding over a "model"
mesh axis (port of srewd_tpu/parallel)."""

from .distributed import (
    ShardedModule, all_gather_rows, barrier, broadcast_object, current_mesh, data_parallel,
    draw_rows, init_distributed, local_device, mean_across, rank, rows, shard_parameters,
    shutdown, world_size)
from .mesh import make_mesh, model_size, param_placement

__all__ = ["ShardedModule", "all_gather_rows", "barrier", "broadcast_object", "current_mesh",
           "data_parallel", "draw_rows", "init_distributed", "local_device", "make_mesh",
           "mean_across", "model_size", "param_placement", "rank", "rows", "shard_parameters",
           "shutdown", "world_size"]
