"""The ("data", "model") process mesh and the placement of parameters on it
(port of srewd_tpu/parallel/mesh.py).

`make_mesh` arranges the ranks of the process group as a
torch.distributed DeviceMesh of shape (world // model_parallel,
model_parallel) named ("data", "model"). `param_placement` is JAX's rule of
lazy tensor parallelism in the port's layout: a parameter is sharded over
"model" when its output-feature axis (flax's last axis) is at least
`min_shard_dim` long and divisible by the "model" size. In torch that axis
is dim 0 of a Conv2d or Linear weight, of every bias and of a norm's affine
parameters, dim 1 of a ConvTranspose2d weight [in, out, kh, kw], and the
last dim of a parameter that keeps flax's layout (PhyConv's `kernels`); the
weight bridge (utils/jax_params.py) maps each of these onto flax's last
axis, so the sharded set is JAX's leaf for leaf.
"""

from __future__ import annotations

from typing import Optional

import torch.distributed as dist
import torch.nn as nn
from torch.nn.modules.conv import _ConvNd, _ConvTransposeNd

from .distributed import world_size


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1):
    """A DeviceMesh over the process group's ranks, rank-major: ranks
    [d * model_parallel, (d + 1) * model_parallel) form data row d. Raises
    when the world is not divisible by `model_parallel` (as JAX's), or
    without a process group. `n_devices` is there for JAX's signature only:
    a mesh spans the whole process group, so any value but its size (the
    default) raises."""
    n = n_devices or world_size()
    if n % model_parallel:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs a process group (parallel.init_distributed)")
    if n != world_size():
        raise ValueError(f"a mesh spans the process group: {n} devices, {world_size()} ranks")
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n // model_parallel, model_parallel),
                            mesh_dim_names=("data", "model"))


def model_size(mesh) -> int:
    """The size of the mesh's "model" axis; 1 without a mesh."""
    return 1 if mesh is None else mesh["model"].size()


def feature_dim(module: nn.Module, name: str, p) -> int:
    """The dim of parameter `name` of `module` (its own, not dotted) that
    holds flax's last axis (the output features)."""
    if isinstance(module, _ConvTransposeNd) and name == "weight":
        return 1
    if isinstance(module, (_ConvNd, nn.Linear)) or p.ndim == 1:
        return 0
    return p.ndim - 1


def param_placement(module: nn.Module, mesh, min_shard_dim: Optional[int] = None) -> dict:
    """{parameter name: the dim it is sharded on over "model", or None for
    replicated}. With min_shard_dim None, or a "model" axis of 1, every
    parameter is replicated (the plain data-parallel placement)."""
    msize = model_size(mesh)
    out = {}
    for mname, m in module.named_modules():
        for pname, p in m.named_parameters(recurse=False):
            d = feature_dim(m, pname, p) if p.ndim else None
            sharded = (min_shard_dim is not None and msize > 1 and d is not None
                       and p.shape[d] >= min_shard_dim and p.shape[d] % msize == 0)
            out[f"{mname}.{pname}" if mname else pname] = d if sharded else None
    return out
