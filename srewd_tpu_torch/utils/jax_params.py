"""Weight bridge between srewd_tpu's flax param trees and the port's
state_dicts, in both directions: the WeatherUNet of every architecture, and
the SimpleCNN and RRDBNet encoders.

The inverse of srewd_tpu/utils/torch_convert.py. Flax names modules in call
order: `ResnetBlockWithAttn_k` counts across downs, mid and ups;
`Downsample_j` / `Upsample_j` count the resampling convs; `CrossAttention_i`
is the i-th downsample boundary; `Conv_0` at the top is the stem,
`Block_0` the final conv, `FDInfoSpliter_0` the spliter (`Dense_0`,
`ResSE_{0,1,2}`, `Conv_0`) and `ConvTranspose_0` the RRDB projection. The
structure (levels, res blocks, mid blocks) is read off the tree itself.
Encoders: SimpleCNN `Conv_{0,1,2}`; RRDBNet `Conv_0` (first),
`RRDB_i/ResidualDenseBlock5C_r/Conv_c`, then `Conv_1..Conv_5` (trunk,
upconv1, upconv2, HRconv, last), as `torch_convert.convert_simple_cnn_state`
and `convert_rrdb_state` name them. PhyConv: `kernels` as it is, `Conv_0`
its 1x1 projection (`conv`).

Layouts: Conv [kh,kw,I,O] -> [O,I,kh,kw]; Dense [I,O] -> Linear [O,I];
ConvTranspose [kh,kw,I,O] -> ConvTranspose2d [I,O,kh,kw] with the kernel
flipped (flax correlates where torch convolves); GroupNorm `scale` ->
`weight`. Gradients and optimizer moments have their parameters' layouts,
so the same maps carry them: `unet_state_from_jax` of a JAX gradient tree
gives the port's gradients by parameter name, and
`jax_tree_from_unet_state(grads, like=params_tree)` the other way (the
`encoder_*` pair likewise).

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


# JAX layout -> torch layout, and back, per kind of leaf
_TO_TORCH = {
    "conv": lambda w: np.transpose(w, (3, 2, 0, 1)),
    "convT": lambda w: np.transpose(w[::-1, ::-1], (2, 3, 0, 1)),
    "lin": lambda w: np.transpose(w, (1, 0)),
    "same": lambda w: w,
}
_TO_JAX = {
    "conv": lambda w: np.transpose(w, (2, 3, 1, 0)),
    "convT": lambda w: np.transpose(w, (2, 3, 0, 1))[::-1, ::-1],
    "lin": lambda w: np.transpose(w, (1, 0)),
    "same": lambda w: w,
}


class _Spec:
    """Records port key -> (JAX path, kind) while reading a tree's layout."""

    def __init__(self, tree: dict):
        self.t = _Tree(tree)
        self.map: "OrderedDict[str, tuple]" = OrderedDict()

    def has(self, *path) -> bool:
        return self.t.has(*path)

    def get(self, *path):
        self.t.get(*path)
        return (path, "same")


def _conv(leaf):
    return (leaf[0], "conv")


def _lin(leaf):
    return (leaf[0], "lin")


def _check_consumed(t: _Spec) -> "OrderedDict[str, tuple]":
    unused = t.t.leaves() - t.t.used
    if unused:
        raise ValueError(f"params not consumed by the port: {sorted('/'.join(p) for p in unused)}")
    return t.map


def _key_map(tree: dict) -> "OrderedDict[str, tuple]":
    """port state_dict key -> (JAX tree path, layout kind) for a flax
    WeatherUNet tree (any variant). Raises if a leaf is left unused."""
    t = _Spec(tree)
    sd = t.map

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
    # every variant but sr3 (no cross-attention, spliter or RRDB projection)
    # has an attention block and a plain block in the middle
    n_mid = 2 if any(t.has(k) for k in ("CrossAttention_0", "FDInfoSpliter_0",
                                          "ConvTranspose_0")) else 1
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
    if t.has("FDInfoSpliter_0"):
        fd = "FDInfoSpliter_0"
        sd["fd_spliter.noise_func.weight"] = _lin(t.get(fd, "Dense_0", "kernel"))
        sd["fd_spliter.noise_func.bias"] = t.get(fd, "Dense_0", "bias")
        for j, name in enumerate(("noise_resSE", "sigma_resSE", "HF_guided_resSE")):
            for fc, dense in ((0, "Dense_0"), (2, "Dense_1")):
                sd[f"fd_spliter.{name}.fc.{fc}.weight"] = _lin(
                    t.get(fd, f"ResSE_{j}", dense, "kernel"))
        sd["fd_spliter.channel_transform.weight"] = _conv(t.get(fd, "Conv_0", "kernel"))
        sd["fd_spliter.channel_transform.bias"] = t.get(fd, "Conv_0", "bias")
    if t.has("ConvTranspose_0"):
        sd["cond_proj.weight"] = (t.get("ConvTranspose_0", "kernel")[0], "convT")
        sd["cond_proj.bias"] = t.get("ConvTranspose_0", "bias")
    return _check_consumed(t)


def _encoder_key_map(tree: dict) -> "OrderedDict[str, tuple]":
    """The same for a flax SimpleCNN or RRDBNet tree (an RRDBNet has RRDB_0)."""
    t = _Spec(tree)
    sd = t.map

    def conv(key, *path):
        sd[f"{key}.weight"] = _conv(t.get(*path, "kernel"))
        sd[f"{key}.bias"] = t.get(*path, "bias")

    if not t.has("RRDB_0"):
        for i in range(3):
            conv(f"conv{i + 1}", f"Conv_{i}")
        return _check_consumed(t)
    conv("conv_first", "Conv_0")
    i = 0
    while t.has(f"RRDB_{i}"):
        for r in range(3):
            for c in range(5):
                conv(f"RRDB_trunk.{i}.RDB{r + 1}.conv{c + 1}", f"RRDB_{i}",
                     f"ResidualDenseBlock5C_{r}", f"Conv_{c}")
        i += 1
    for j, name in enumerate(("trunk_conv", "upconv1", "upconv2", "HRconv", "conv_last"),
                             start=1):
        conv(name, f"Conv_{j}")
    return _check_consumed(t)


def _phy_conv_key_map(tree: dict) -> "OrderedDict[str, tuple]":
    """The same for a flax PhyConv tree."""
    t = _Spec(tree)
    t.map["kernels"] = t.get("kernels")
    t.map["conv.weight"] = _conv(t.get("Conv_0", "kernel"))
    t.map["conv.bias"] = t.get("Conv_0", "bias")
    return _check_consumed(t)


def _get(tree: dict, path: tuple) -> np.ndarray:
    node = tree
    for p in path:
        node = node[p]
    return np.asarray(node)


def _state(spec: Mapping, tree: dict) -> "OrderedDict[str, torch.Tensor]":
    return OrderedDict(
        (key, torch.from_numpy(np.ascontiguousarray(_TO_TORCH[kind](_get(tree, path)),
                                                    dtype=np.float32)))
        for key, (path, kind) in spec.items()
    )


def _tree(spec: Mapping, state: Mapping) -> dict:
    if set(spec) != set(state):
        raise ValueError(f"keys differ: only in the port {sorted(set(state) - set(spec))}, "
                         f"only in the tree {sorted(set(spec) - set(state))}")
    out: dict = {}
    for key, (path, kind) in spec.items():
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        v = state[key]
        v = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        node[path[-1]] = np.ascontiguousarray(_TO_JAX[kind](v), dtype=np.float32)
    return out


def unet_state_from_jax(tree: dict) -> "OrderedDict[str, torch.Tensor]":
    """Map a flax WeatherUNet tree (params, or anything of their layout:
    gradients, optimizer moments) to the port's state_dict keys.

    Raises if a leaf of the tree is left unused; `load_state_dict(strict=True)`
    then catches any key the port expects and the tree lacks.
    """
    return _state(_key_map(tree), tree)


def jax_tree_from_unet_state(state: Mapping, like: dict) -> dict:
    """The inverse: a port state_dict (or gradients / moments by parameter
    name) as a nested dict of float32 numpy arrays in the layout of the JAX
    tree `like` (only its structure is read)."""
    return _tree(_key_map(like), state)


def encoder_state_from_jax(tree: dict) -> "OrderedDict[str, torch.Tensor]":
    """unet_state_from_jax for a SimpleCNN or RRDBNet tree."""
    return _state(_encoder_key_map(tree), tree)


def jax_tree_from_encoder_state(state: Mapping, like: dict) -> dict:
    """jax_tree_from_unet_state for a SimpleCNN or RRDBNet tree."""
    return _tree(_encoder_key_map(like), state)


def phy_conv_state_from_jax(tree: dict) -> "OrderedDict[str, torch.Tensor]":
    """unet_state_from_jax for a PhyConv tree."""
    return _state(_phy_conv_key_map(tree), tree)


def jax_tree_from_phy_conv_state(state: Mapping, like: dict) -> dict:
    """jax_tree_from_unet_state for a PhyConv tree."""
    return _tree(_phy_conv_key_map(like), state)


def optimizer_moments(optimizer, module) -> dict:
    """An optimizer's per-parameter state tensors by the module's parameter
    names ({"exp_avg": {name: tensor}, "exp_avg_sq": {...}} for Adam), for
    `jax_tree_from_unet_state` to compare with optax's moments."""
    names = {id(p): n for n, p in module.named_parameters()}
    out: dict = {}
    for p, st in optimizer.state.items():
        for key, val in st.items():
            if isinstance(val, torch.Tensor) and val.shape == p.shape:
                out.setdefault(key, {})[names[id(p)]] = val
    return out


# optax's state fields of the port's per-parameter state: Adam and Lamb keep
# (exp_avg, exp_avg_sq, step) as optax's ScaleByAdamState (mu, nu, count),
# Lion keeps (exp_avg, step) as ScaleByLionState (mu, count)
OPTAX_FIELDS = {"exp_avg": "mu", "exp_avg_sq": "nu"}


def optax_state(optimizer, module, to_tree) -> dict:
    """The optimizer's state in optax's fields: {"mu": tree, "nu": tree
    (Adam, Lamb), "count": int}. `to_tree` maps {parameter name: tensor} to
    the JAX layout (`partial(jax_tree_from_unet_state, like=params)`)."""
    moments = optimizer_moments(optimizer, module)
    counts = {int(st["step"]) for st in optimizer.state.values()}
    if len(counts) != 1:
        raise ValueError(f"the parameters' step counts differ: {sorted(counts)}")
    out = {f: to_tree(moments[k]) for k, f in OPTAX_FIELDS.items() if k in moments}
    out["count"] = counts.pop()
    return out


def load_optax_state(optimizer, module, state: dict, from_tree) -> None:
    """The inverse of optax_state: every parameter of `module` in the
    optimizer takes its moments from optax's fields of `state` ({"mu",
    "nu" where the optimizer keeps it, "count"}) and the step count;
    `from_tree` maps a JAX tree to {parameter name: tensor}
    (`unet_state_from_jax`)."""
    fields = {k: from_tree(state[f]) for k, f in OPTAX_FIELDS.items() if f in state}
    owned = {id(p) for group in optimizer.param_groups for p in group["params"]}
    for name, p in module.named_parameters():
        if id(p) not in owned:
            continue
        st = optimizer.state[p]
        st["step"] = torch.tensor(float(state["count"]))
        for key, tensors in fields.items():
            st[key] = tensors[name].to(device=p.device, dtype=p.dtype).clone()


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

