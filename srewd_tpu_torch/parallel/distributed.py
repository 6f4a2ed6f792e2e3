"""Data parallelism over processes: one process per card, the global batch
split by rank (port of srewd_tpu/parallel/mesh.py).

The JAX package shards the global batch over a device mesh and lets XLA
insert the gradient reduction; across hosts each process contributes its
own rows (`jax.make_array_from_process_local_data`, trainer.py:228-244).
The port runs one process per card under torchrun and wraps the training
loss in DistributedDataParallel (`data_parallel`), which averages the
gradients over the ranks in the backward. Parameters are replicated: DDP
broadcasts rank 0's when it wraps. Each rank calls K1, K2 and K3 on its own
rows, so the JAX package's shard_map routing of the kernels has none.

Parameter sharding over a "model" axis (`init_distributed(model_parallel=)`
builds the ("data", "model") mesh of parallel/mesh.py; `shard_parameters`)
is the PyTorch idiom for what GSPMD does with JAX's `param_placement`:
hybrid sharded data parallelism. The parameters that the placement shards
are held as this rank's rows (mesh.feature_dim) over the "model" group, the
rest whole; the optimizer's moments and the EMA are made from the held
tensors, so they follow. Every rank is a data-parallel rank of the whole
world: each forward gathers the full weights (one all_gather over
"model"), the module runs on them, and after the backward the full
gradients are reduced (one reduce_scatter over "model", one all_reduce over
"data", one all_reduce over the world for the replicated leaves), so the
step is data parallelism's math. The kernels see full, gathered tensors.
So sharding saves the memory of the weights and moments at rest, not the
step's peak: the full weights and the full gradients are live through the
backward. Collectives move through `_transport()`: the card under NCCL,
the host under gloo.

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
_MESH = [None]  # the ("data", "model") mesh init_distributed built, if any


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


def init_distributed(backend: str | None = None, model_parallel: int = 1) -> None:
    """Join the process group that torchrun's environment describes (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT; all must be set).
    `backend`: "nccl" (the card: the rank's card becomes the current one)
    or "gloo" (the CPU); None takes NCCL when a card is there. With
    `model_parallel` > 1 it builds the ("data", "model") mesh once
    (`current_mesh`); with 1 there is none and every rank is a plain
    data-parallel rank."""
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
    if model_parallel > 1:
        from .mesh import make_mesh

        _MESH[0] = make_mesh(model_parallel=model_parallel)


def current_mesh():
    """The mesh init_distributed built, or None."""
    return _MESH[0]


def shutdown() -> None:
    """Leave the process group (no-op without one)."""
    _MESH[0] = None
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
    host under gloo. gloo takes CUDA tensors too (broadcast, all_reduce,
    all_gather, all_gather_into_tensor and reduce_scatter_tensor:
    `chip_smoke.py --gloo-cuda`), staging them through host memory itself;
    the copy is made here instead."""
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


def _owner(module: nn.Module, name: str) -> tuple:
    """(the submodule holding parameter `name`, its own name there)."""
    path, _, leaf = name.rpartition(".")
    return (module.get_submodule(path) if path else module), leaf


class ShardedModule:
    """`module` with the leaves that `param_placement` shards held as this
    rank's rows over the mesh's "model" group (see the module's docstring).

    Calling it gathers the full weights and runs `module` on them
    (torch.func.functional_call); `reduce_gradients()`, after the backward,
    gives every held leaf the world's mean gradient of its rows. The
    parameters are named as in `module`; `dims` maps each sharded one to
    the dim it is split on.
    """

    def __init__(self, module: nn.Module, mesh, min_shard_dim: int):
        from .mesh import param_placement

        self.module = module
        self.model_group = mesh.get_group("model")
        self.data_group = mesh.get_group("data")
        self.m = mesh["model"].size()
        self.r = mesh.get_local_rank("model")
        self.dims = {n: d for n, d in param_placement(module, mesh, min_shard_dim).items()
                     if d is not None}
        self._full: dict = {}
        params = dict(module.named_parameters())
        with torch.no_grad():
            self._broadcast(list(params.values()))  # rank 0's weights, as DDP's wrap
            for name, d in self.dims.items():
                p = params[name]
                owner, leaf = _owner(module, name)
                setattr(owner, leaf, nn.Parameter(p.detach().chunk(self.m, d)[self.r].clone(),
                                                  requires_grad=p.requires_grad))

    # ------------------------------------------------------------ collectives
    @staticmethod
    def _broadcast(tensors: list) -> None:
        flat = torch.cat([t.detach().reshape(-1) for t in tensors]).to(_transport())
        dist.broadcast(flat, src=0)
        flat = flat.to(tensors[0].device).split([t.numel() for t in tensors])
        torch._foreach_copy_(tensors, [v.view_as(t) for t, v in zip(tensors, flat)])

    def gather(self, shards: list, dims: list) -> list:
        """The full tensors of which `shards` hold this rank's rows along
        `dims`: one all_gather over "model"."""
        if not shards:
            return []
        flat = torch.cat([s.detach().reshape(-1) for s in shards]).to(_transport())
        out = torch.empty(self.m * flat.numel(), dtype=flat.dtype, device=flat.device)
        dist.all_gather_into_tensor(out, flat, group=self.model_group)
        rows = out.to(shards[0].device).view(self.m, -1)
        full, off = [], 0
        for s, d in zip(shards, dims):
            n = s.numel()
            full.append(torch.cat([rows[i, off:off + n].view(s.shape) for i in range(self.m)],
                                  dim=d))
            off += n
        return full

    def _reduce_scatter(self, grads: list, dims: list) -> list:
        """This rank's rows of the world's mean of the full `grads`."""
        parts = [g.chunk(self.m, d) for g, d in zip(grads, dims)]
        buf = torch.cat([c[i].reshape(-1) for i in range(self.m) for c in parts])
        buf = buf.to(_transport())
        out = torch.empty(buf.numel() // self.m, dtype=buf.dtype, device=buf.device)
        dist.reduce_scatter_tensor(out, buf, group=self.model_group)
        if dist.get_world_size(self.data_group) > 1:
            dist.all_reduce(out, group=self.data_group)
        out = (out / world_size()).to(grads[0].device)
        return [o.view(c[self.r].shape) for o, c in zip(
            out.split([c[self.r].numel() for c in parts]), parts)]

    # ------------------------------------------------------------------ step
    def __call__(self, *args, **kwargs):
        from torch.func import functional_call

        params = dict(self.module.named_parameters())
        names = list(self.dims)
        full = self.gather([params[n] for n in names], [self.dims[n] for n in names])
        self._full = {n: f.requires_grad_(params[n].requires_grad) for n, f in zip(names, full)}
        return functional_call(self.module, self._full, args, kwargs)

    @torch.no_grad()
    def reduce_gradients(self) -> None:
        """After the backward: every held leaf's .grad is the world's mean
        gradient of its rows (sharded) or of itself (replicated)."""
        params = dict(self.module.named_parameters())
        names = [n for n, f in self._full.items() if f.grad is not None]
        if names:
            for n, g in zip(names, self._reduce_scatter([self._full[n].grad for n in names],
                                                        [self.dims[n] for n in names])):
                params[n].grad = g
        self._full = {}
        reps = [p for n, p in params.items() if n not in self.dims and p.grad is not None]
        if reps and world_size() > 1:
            flat = torch.cat([p.grad.reshape(-1) for p in reps]).to(_transport())
            dist.all_reduce(flat)
            flat = (flat / world_size()).to(reps[0].device)
            for p, g in zip(reps, flat.split([p.numel() for p in reps])):
                p.grad.copy_(g.view_as(p.grad))

    def leaf_norms(self, params: list, tensors: list) -> torch.Tensor:
        """The 2-norm of each full tensor of which `tensors[i]` holds the
        rows that `params[i]` holds (a gradient, an update): the local norms,
        summed in squares over "model" for the sharded leaves."""
        sq = torch.stack(torch._foreach_norm(tensors)).square()
        sharded = {id(p) for n, p in self.module.named_parameters() if n in self.dims}
        idx = [i for i, p in enumerate(params) if id(p) in sharded]
        if idx:
            part = sq[idx].to(_transport())
            dist.all_reduce(part, group=self.model_group)
            sq[idx] = part.to(sq.device)
        return sq.sqrt()

    # ----------------------------------------------------------------- state
    def full_state(self, state: dict, prefix: str = "") -> dict:
        """`state` (a state_dict of the submodule at `prefix`, or tensors of
        its parameters' shapes by the same names) with every sharded entry
        gathered whole; the others as they are. Every rank must call it."""
        keys = [k for k in state if prefix + k in self.dims]
        full = self.gather([state[k] for k in keys], [self.dims[prefix + k] for k in keys])
        out = dict(state)
        out.update(zip(keys, full))
        return out

    def local_state(self, state: dict, prefix: str = "") -> dict:
        """The inverse: every sharded entry of a full `state` cut to this
        rank's rows (a copy), the others as they are."""
        out = dict(state)
        for k, v in state.items():
            d = self.dims.get(prefix + k)
            if d is not None:
                out[k] = v.chunk(self.m, d)[self.r].clone()
        return out


def shard_parameters(module: nn.Module, mesh, min_shard_dim: int) -> ShardedModule:
    """`module` sharded over `mesh`'s "model" axis by `param_placement`
    (ShardedModule); replaces the sharded parameters in place, so build the
    optimizer after it."""
    return ShardedModule(module, mesh, min_shard_dim)
