"""Data parallelism over processes (port of srewd_tpu/parallel)."""

from .distributed import (
    all_gather_rows, barrier, broadcast_object, data_parallel, draw_rows, init_distributed,
    local_device, mean_across, rank, rows, shutdown, world_size)

__all__ = ["all_gather_rows", "barrier", "broadcast_object", "data_parallel", "draw_rows",
           "init_distributed", "local_device", "mean_across", "rank", "rows", "shutdown",
           "world_size"]
