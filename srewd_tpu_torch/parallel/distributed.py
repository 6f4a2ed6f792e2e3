"""Data parallelism over processes: one process per card, the global batch
split by rank (port of srewd_tpu/parallel/mesh.py).

The JAX package shards the global batch over a device mesh and lets XLA
insert the gradient reduction; across hosts each process contributes its
own rows (`jax.make_array_from_process_local_data`, trainer.py:228-244).
The port runs one process per card under torchrun and wraps the training
loss in DistributedDataParallel (`data_parallel`), which averages the
gradients over the ranks in the backward. Parameters are replicated: DDP
broadcasts rank 0's when it wraps, and `param_placement`'s tensor
parallelism has no counterpart. Each rank calls K1, K2 and K3 on its own
rows, so the JAX package's shard_map routing of the kernels has none either.

The global batch is rank-major: rank r holds rows [r B, (r + 1) B) of
W B rows (W ranks, B rows each; `rows`). Draws that JAX makes over the
global array (the training noise, gamma's uniforms, the dropout masks, the
chain noise) are made over the global shape on every rank from the same
seed, and each rank keeps its rows, so W ranks at batch B compute what one
process computes at batch W B.

Without a process group (`init_distributed` not called) `rank()` is 0,
`world_size()` 1, and every function here is the identity or a no-op: a
single process runs the same code.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
import torch.nn as nn

_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def _joined() -> bool:
    return dist.is_available() and dist.is_initialized()


def local_device(name: str) -> torch.device:
    """The device of this rank for `--device name`: the CPU for "cpu",
    cuda:LOCAL_RANK for "cuda". Raises when LOCAL_RANK is not below the
    card count or when no card is there (no wrap-around, no CPU instead)."""
    device = torch.device(name)
    if device.type != "cuda":
        return device
    if device.index is not None:
        raise ValueError(f"--device {name}: under torchrun each rank takes cuda:LOCAL_RANK; "
                         "pass --device cuda")
    if "LOCAL_RANK" not in os.environ:
        raise RuntimeError("local_device needs torchrun's LOCAL_RANK")
    local = int(os.environ["LOCAL_RANK"])
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if local >= count:
        raise RuntimeError(f"LOCAL_RANK {local} has no card: {count} visible")
    return torch.device("cuda", local)


def init_distributed(backend: str | None = None) -> None:
    """Join the process group that torchrun's environment describes (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT; all must be set).
    `backend`: "nccl" (the card: the rank's card becomes the current one)
    or "gloo" (the CPU); None takes NCCL when a card is there."""
    missing = [k for k in _ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"init_distributed: torchrun's {', '.join(missing)} not set")
    if _joined():
        raise RuntimeError("init_distributed: the process group is already joined")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = {}
    if backend == "nccl":
        kw["device_id"] = local_device("cuda")
        torch.cuda.set_device(kw["device_id"])
    dist.init_process_group(backend, init_method="env://", rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]), **kw)


def shutdown() -> None:
    """Leave the process group (no-op without one)."""
    if _joined():
        dist.destroy_process_group()


def rank() -> int:
    return dist.get_rank() if _joined() else 0


def world_size() -> int:
    return dist.get_world_size() if _joined() else 1


def barrier() -> None:
    if _joined():
        dist.barrier()


def rows(n_local: int) -> slice:
    """This rank's rows of a global batch of world_size() x n_local rows."""
    r = rank()
    return slice(r * n_local, (r + 1) * n_local)


def draw_rows(draw, n_local: int, *shape, generator=None, device=None) -> torch.Tensor:
    """`draw` (torch.rand or torch.randn) over the global shape
    (world_size() x n_local, *shape), float32; this rank's rows of it."""
    out = draw((world_size() * n_local, *shape), generator=generator, device=device,
               dtype=torch.float32)
    return out[rows(n_local)]


def _transport() -> torch.device:
    """Where collectives move tensors: the current card under NCCL, the
    host under gloo (which gathers no CUDA tensor)."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of `t` concatenated in rank order (the global
    batch, as `rows` splits it), on t's device, on every rank."""
    if world_size() == 1:
        return t
    src = t.to(_transport()).contiguous()
    parts = [torch.empty_like(src) for _ in range(world_size())]
    dist.all_gather(parts, src)
    return torch.cat(parts).to(t.device)


def mean_across(t: torch.Tensor) -> torch.Tensor:
    """The mean of `t` over the ranks, on t's device, on every rank."""
    if world_size() == 1:
        return t
    out = t.to(_transport(), copy=True)
    dist.all_reduce(out)
    return (out / world_size()).to(t.device)


def broadcast_object(obj):
    """Rank 0's `obj` (a picklable value) on every rank."""
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, device=_transport())
    return box[0]


def data_parallel(module: nn.Module, device: torch.device) -> nn.Module:
    """`module` under DistributedDataParallel once a process group is joined
    (its forward hooked, its gradients averaged over the ranks in the
    backward, rank 0's parameters broadcast now); `module` itself otherwise."""
    if not _joined():
        return module
    from torch.nn.parallel import DistributedDataParallel

    ids = None
    if device.type == "cuda":
        ids = [device.index if device.index is not None else torch.cuda.current_device()]
    return DistributedDataParallel(module, device_ids=ids)
