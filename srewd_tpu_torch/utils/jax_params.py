"""Weight bridge: srewd_tpu's flax WeatherUNet param tree -> the port's state_dict.

The inverse of srewd_tpu/utils/torch_convert.py. Flax names modules in call
order: `ResnetBlockWithAttn_k` counts across downs, mid and ups;
`Downsample_j` / `Upsample_j` count the resampling convs; `CrossAttention_i`
is the i-th downsample boundary; `Conv_0` at the top is the stem and
`Block_0` the final conv. The structure (levels, res blocks, mid blocks) is
read off the tree itself.

Layouts: Conv [kh,kw,I,O] -> [O,I,kh,kw]; Dense [I,O] -> Linear [O,I];
GroupNorm `scale` -> `weight`.

`load_npz` reads a `.npz` whose keys are the tree paths joined by "/".
"""

from __future__ import annotations

from collections import OrderedDict
from collections.abc import Mapping

import numpy as np
import torch


class _Tree:
    """Reads leaves of a nested dict and remembers which were read."""

    def __init__(self, tree: dict):
        self.tree = tree
        self.used: set = set()

    def has(self, *path) -> bool:
        node = self.tree
        for p in path:
            if not isinstance(node, Mapping) or p not in node:
                return False
            node = node[p]
        return True

    def get(self, *path) -> np.ndarray:
        node = self.tree
        for p in path:
            node = node[p]
        self.used.add(path)
        return np.asarray(node)

    def leaves(self):
        def walk(node, prefix):
            for k, v in node.items():
                if isinstance(v, Mapping):
                    yield from walk(v, prefix + (k,))
                else:
                    yield prefix + (k,)
        return set(walk(self.tree, ()))


def _conv(w):
    return np.transpose(w, (3, 2, 0, 1))


def _lin(w):
    return np.transpose(w, (1, 0))


def unet_state_from_jax(tree: dict) -> "OrderedDict[str, torch.Tensor]":
    """Map a flax WeatherUNet param tree (sr3 or phydiff) to the port's state_dict.

    Raises if a leaf of the tree is left unused; `load_state_dict(strict=True)`
    then catches any key the port expects and the tree lacks.
    """
    t = _Tree(tree)
    sd: "OrderedDict[str, np.ndarray]" = OrderedDict()

    def block(prefix, *path):
        sd[f"{prefix}.block.0.weight"] = t.get(*path, "FusedGroupNorm_0", "scale")
        sd[f"{prefix}.block.0.bias"] = t.get(*path, "FusedGroupNorm_0", "bias")
        sd[f"{prefix}.block.3.weight"] = _conv(t.get(*path, "Conv_0", "kernel"))
        sd[f"{prefix}.block.3.bias"] = t.get(*path, "Conv_0", "bias")

    def rba(prefix, k):
        rb = (f"ResnetBlockWithAttn_{k}", "ResnetBlock_0")
        block(f"{prefix}.res_block.block1", *rb, "Block_0")
        sd[f"{prefix}.res_block.noise_func.noise_func.0.weight"] = _lin(
            t.get(*rb, "FeatureWiseAffine_0", "Dense_0", "kernel"))
        sd[f"{prefix}.res_block.noise_func.noise_func.0.bias"] = t.get(
            *rb, "FeatureWiseAffine_0", "Dense_0", "bias")
        block(f"{prefix}.res_block.block2", *rb, "Block_1")
        if t.has(*rb, "Conv_0"):
            sd[f"{prefix}.res_block.res_conv.weight"] = _conv(t.get(*rb, "Conv_0", "kernel"))
            sd[f"{prefix}.res_block.res_conv.bias"] = t.get(*rb, "Conv_0", "bias")
        at = (f"ResnetBlockWithAttn_{k}", "SelfAttention_0")
        if t.has(*at):
            sd[f"{prefix}.attn.norm.weight"] = t.get(*at, "FusedGroupNorm_0", "scale")
            sd[f"{prefix}.attn.norm.bias"] = t.get(*at, "FusedGroupNorm_0", "bias")
            sd[f"{prefix}.attn.qkv.weight"] = _conv(t.get(*at, "Conv_0", "kernel"))
            sd[f"{prefix}.attn.out.weight"] = _conv(t.get(*at, "Conv_1", "kernel"))
            sd[f"{prefix}.attn.out.bias"] = t.get(*at, "Conv_1", "bias")

    def resample(prefix, name):
        sd[f"{prefix}.conv.weight"] = _conv(t.get(name, "Conv_0", "kernel"))
        sd[f"{prefix}.conv.bias"] = t.get(name, "Conv_0", "bias")

    for i, j in ((1, 0), (3, 1)):
        sd[f"noise_level_mlp.{i}.weight"] = _lin(t.get("NoiseLevelMLP_0", f"Dense_{j}", "kernel"))
        sd[f"noise_level_mlp.{i}.bias"] = t.get("NoiseLevelMLP_0", f"Dense_{j}", "bias")
    sd["downs.0.weight"] = _conv(t.get("Conv_0", "kernel"))
    sd["downs.0.bias"] = t.get("Conv_0", "bias")

    n_down = sum(1 for k in tree if k.startswith("Downsample_"))
    n_rba = sum(1 for k in tree if k.startswith("ResnetBlockWithAttn_"))
    n_levels = n_down + 1
    n_mid = 2 if t.has("CrossAttention_0") else 1  # phydiff: attn + plain
    res_blocks = ((n_rba - n_mid) // n_levels - 1) // 2
    if n_levels * (2 * res_blocks + 1) + n_mid != n_rba:
        raise ValueError(f"cannot read a UNet layout off {n_rba} ResnetBlockWithAttn "
                         f"modules and {n_down} Downsample modules")

    k = idx = 0
    for level in range(n_levels):
        for _ in range(res_blocks):
            idx += 1
            rba(f"downs.{idx}", k)
            k += 1
        if level < n_levels - 1:
            idx += 1
            resample(f"downs.{idx}", f"Downsample_{level}")
    for i in range(n_mid):
        rba(f"mid.{i}", k)
        k += 1
    idx = -1
    for level in range(n_levels):
        for _ in range(res_blocks + 1):
            idx += 1
            rba(f"ups.{idx}", k)
            k += 1
        if level < n_levels - 1:
            idx += 1
            resample(f"ups.{idx}", f"Upsample_{level}")
    i = 0
    while t.has(f"CrossAttention_{i}"):
        ca = f"CrossAttention_{i}"
        sd[f"hf_ca_list.{i}.norm.weight"] = t.get(ca, "FusedGroupNorm_0", "scale")
        sd[f"hf_ca_list.{i}.norm.bias"] = t.get(ca, "FusedGroupNorm_0", "bias")
        sd[f"hf_ca_list.{i}.kv.weight"] = _conv(t.get(ca, "Conv_0", "kernel"))
        sd[f"hf_ca_list.{i}.q.weight"] = _conv(t.get(ca, "Conv_1", "kernel"))
        sd[f"hf_ca_list.{i}.out.weight"] = _conv(t.get(ca, "Conv_2", "kernel"))
        sd[f"hf_ca_list.{i}.out.bias"] = t.get(ca, "Conv_2", "bias")
        i += 1
    block("final_conv", "Block_0")

    unused = t.leaves() - t.used
    if unused:
        raise ValueError(f"params not consumed by the port: {sorted('/'.join(p) for p in unused)}")
    return OrderedDict(
        (key, torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))) for key, v in sd.items()
    )


def load_npz(path: str) -> dict:
    """Nested param tree from an .npz whose keys are tree paths joined by '/'."""
    tree: dict = {}
    with np.load(path, allow_pickle=False) as z:
        for key in z.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return tree

