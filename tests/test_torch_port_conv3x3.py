"""K4, the float32 3x3 convolution (srewd_tpu_torch/ops/conv3x3.py,
csrc/conv3x3.cu), on the CPU.

The kernel runs only on a card; here: its plain version against float64
convolutions at the channel shapes of the UNets and the RRDB (small maps);
the kernel's arithmetic emulated in numpy (the 3xTF32 split of
test_torch_port_mma_numerics.py, a fresh truncating chain per (chunk, tap)
stage, the stages and the splits added in float32) against float64, and
one-pass TF32 beside it; the plan; which calls the layers route to K4 and
which bypass, a forward that records an autograd graph (training) among
the latter; the custom op's fake and
an exported small UNet; the launch counter and the weight split's cache
with the CUDA route mocked.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

from srewd_tpu_torch.cli import random_init_
from srewd_tpu_torch.models.factory import build_model
from srewd_tpu_torch.models.layers import Conv2d
from srewd_tpu_torch.ops import conv3x3 as k4
from srewd_tpu_torch.ops import reference_ops

from test_torch_port_mma_numerics import K1_REL, chain, one_pass, three_x

# (batch, Cin, Cout, H, W): channel shapes of the phydiff UNet (64 ... 1024 in,
# 64 ... 512 out) and the RRDB's dense blocks (64 ... 192 in, 32 or 64 out)
PLAIN_SHAPES = [(2, 64, 64, 8, 16), (1, 128, 256, 6, 10), (1, 1024, 512, 2, 4),
                (2, 64, 32, 8, 16), (2, 192, 64, 5, 7), (1, 40, 96, 3, 5)]
# the emulation's shapes: unsplit, split over chunks, a partial last chunk
EMULATED_SHAPES = [(1, 32, 32, 4, 8), (1, 256, 64, 2, 4), (1, 40, 32, 3, 5)]


def _inputs(n, cin, cout, h, w, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, cin, h, w, generator=g).to(dtype).contiguous(
        memory_format=torch.channels_last)
    wt = (torch.randn(cout, cin, 3, 3, generator=g) / np.sqrt(9 * cin)).to(dtype)
    b = torch.randn(cout, generator=g).to(dtype)
    return x, wt, b


def _rel(got, want):
    want = want.double()
    return ((got.double() - want).abs().max() / max(1.0, want.abs().max().item())).item()


@pytest.mark.parametrize("shape", PLAIN_SHAPES)
def test_plain_version_matches_float64(shape):
    x, wt, b = _inputs(*shape)
    want = F.conv2d(x.double(), wt.double(), b.double(), padding=1)
    got = k4.conv3x3_reference(x, wt, b)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert _rel(got, want) <= K1_REL
    # in float64 the plain version is the convolution itself
    got64 = k4.conv3x3_reference(x.double(), wt.double(), None)
    torch.testing.assert_close(got64, F.conv2d(x.double(), wt.double(), padding=1),
                               rtol=1e-12, atol=1e-12)


def emulated_k4(x, wt, b, ops=three_x):
    """K4's arithmetic in numpy: per work item of conv3x3_plan's split, per
    chunk of 32 input channels and per tap, one chain of k-steps of 8
    (`ops` passes, truncating adds) started fresh and added to the float32
    running sum; the splits' sums added in split order, then the bias."""
    f32, f64 = np.float32, np.float64
    n, cin, h, w = x.shape
    cout = wt.shape[0]
    plan = k4.conv3x3_plan(n, cin, cout, h, w)
    chunks = -(-cin // k4.CHUNK)
    pad = np.zeros((n, chunks * k4.CHUNK, h + 2, w + 2), f32)
    pad[:, :cin, 1:-1, 1:-1] = x.numpy()
    wp = np.zeros((cout, chunks * k4.CHUNK, 3, 3), f32)
    wp[:, :cin] = wt.numpy()
    total = None
    for s in range(plan.splits):
        acc = np.zeros((n * h * w, cout), f32)
        for c in range(s * chunks // plan.splits, (s + 1) * chunks // plan.splits):
            cs = slice(c * k4.CHUNK, (c + 1) * k4.CHUNK)
            for tap in range(9):
                dy, dx = divmod(tap, 3)
                a = pad[:, cs, dy:dy + h, dx:dx + w].transpose(0, 2, 3, 1).reshape(-1, k4.CHUNK)
                acc = (acc.astype(f64) + chain(ops(a, wp[:, cs, dy, dx].T))).astype(f32)
        total = acc if total is None else (total.astype(f64) + acc).astype(f32)
    out = (total.astype(f64) + b.numpy()).astype(f32)
    return torch.from_numpy(out.reshape(n, h, w, cout)).permute(0, 3, 1, 2)


@pytest.mark.parametrize("shape", EMULATED_SHAPES)
def test_emulated_3xtf32_stays_within_the_float32_tolerance(shape):
    x, wt, b = _inputs(*shape, seed=1)
    want = F.conv2d(x.double(), wt.double(), b.double(), padding=1)
    err = _rel(emulated_k4(x, wt, b), want)
    assert err <= K1_REL
    assert err < 1e-6  # float32-accurate
    # one TF32 pass is not
    assert _rel(emulated_k4(x, wt, b, ops=one_pass), want) > K1_REL


# (batch, Cin, Cout, H, W) -> (BN, splits): phydiff's levels at batch 8, the
# RRDB's convolutions and the smallest level at batch 16 (srdiff's training)
PLANS = {(8, 64, 64, 128, 256): (64, 1), (8, 256, 256, 64, 128): (128, 1),
         (8, 512, 512, 16, 32): (128, 1), (8, 512, 512, 8, 16): (128, 4),
         (8, 1024, 512, 8, 16): (128, 4), (16, 160, 32, 32, 64): (32, 1),
         (16, 192, 64, 32, 64): (64, 1), (16, 512, 512, 8, 16): (128, 2)}


@pytest.mark.parametrize("shape", sorted(PLANS))
def test_plan(shape):
    n, cin, cout, h, w = shape
    p = k4.conv3x3_plan(*shape)
    assert (p.bn, p.splits) == PLANS[shape]
    assert cout % p.bn == 0 and 1 <= p.splits <= p.chunks == -(-cin // 32)
    assert p.tiles == n * -(-h // 8) * -(-w // 16) * (cout // p.bn)
    assert p.items == p.tiles * p.splits and p.grid == min(p.items, k4.SMS)
    # a split only where the tiles make less than one wave, and then the
    # items fill at least half of the SMs
    assert p.splits == 1 or (p.tiles < k4.SMS and p.items >= k4.SMS // 2)


CUDA = torch.device("cuda")
ROUTE_CASES = {
    "3x3 float32": (dict(cin=64, cout=64), torch.float32, True),
    "rrdb cout 32": (dict(cin=96, cout=32), torch.float32, True),
    "bf16": (dict(cin=64, cout=64), torch.bfloat16, False),
    "1x1": (dict(cin=64, cout=192, k=1, padding=0), torch.float32, False),
    "stride 2": (dict(cin=64, cout=64, stride=2), torch.float32, False),
    "stem cin 5": (dict(cin=5, cout=64), torch.float32, False),
    "head cout 1": (dict(cin=64, cout=1), torch.float32, False),
    "reflect padding": (dict(cin=64, cout=64, padding_mode="reflect"), torch.float32, False),
}


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_routing_predicate(case):
    kw, dtype, want = ROUTE_CASES[case]
    layer = Conv2d(kw["cin"], kw["cout"], kw.get("k", 3), stride=kw.get("stride", 1),
                   padding=kw.get("padding", 1), padding_mode=kw.get("padding_mode", "zeros"))

    def routes(x):
        w = layer.weight.to(x.dtype)
        return k4.routes(x, w, layer.bias, layer.stride, layer.padding, layer.dilation,
                         layer.groups, layer.padding_mode)

    with FakeTensorMode(allow_non_fake_inputs=True), torch.no_grad():
        assert routes(torch.empty(2, kw["cin"], 8, 16, device=CUDA, dtype=dtype)) is want
    # a CPU call, not traced, keeps torch's convolution
    with torch.no_grad():
        assert routes(torch.zeros(2, kw["cin"], 8, 16, dtype=dtype)) is False


def _k4_calls(model, batch, lr_hw=(32, 64)):
    """The Conv2d calls of the chain's conditioning and one UNet call whose
    shape K4 takes (float32), counted by hooks on the meta device."""
    calls = []

    def hook(mod, inp):
        if inp[0].dtype == torch.float32 and k4.takes(mod.weight, mod.stride, mod.padding,
                                                        mod.dilation, mod.groups,
                                                        mod.padding_mode):
            calls.append((mod.in_channels, mod.out_channels, inp[0].shape[2]))

    nets = [model.unet] + ([model.encoder] if model.encoder is not None else [])
    hooks = [m.register_forward_pre_hook(hook) for net in nets for m in net.modules()
             if isinstance(m, Conv2d)]
    meta = torch.device("meta")
    with reference_ops(), torch.no_grad():
        cond, denoise = model.denoiser({"LR": torch.empty(batch, *lr_hw, 1, device=meta)})
        denoise(torch.empty_like(cond), torch.empty(batch, device=meta))
    for h in hooks:
        h.remove()
    return calls


@pytest.mark.parametrize("arch,batch,want,rrdb", [("phydiff", 8, 58, 0), ("srdiff", 16, 317, 255)])
def test_main_path_calls_route_to_k4(arch, batch, want, rrdb):
    """phydiff's UNet call has 58 such convolutions (its stem, head, 1x1
    and stride-2 ones bypass); srdiff's training forward 317, the RRDB's 17
    x 3 x 5 dense-block convolutions (Cout 32 and 64) among them."""
    from srewd_tpu_torch.configs.config import load_commented_json

    cfg = {"phydiff": "configs/experiment_configs/phydiff/resdiff+physics_ddim25_eval.json",
           "srdiff": "configs/experiment_configs/srdiff/srdiff+rrdb_unlocked.json"}[arch]
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with torch.device("meta"):
        model = build_model(load_commented_json(os.path.join(root, cfg))["model"])
    calls = _k4_calls(model, batch)
    assert len(calls) == want
    dense = [c for c in calls if c[1] == 32 or c == (192, 64, 32)]  # the RRDB's, at LR
    assert len(dense) == rrdb


@pytest.mark.parametrize("needs_grad", [None, "x", "weight", "bias"])
def test_graph_recording_forward_bypasses_k4(needs_grad):
    """A forward that records an autograd graph (grad enabled and some input
    needing a gradient: training) keeps cuDNN's convolution; without grad, or
    with nothing needing one, K4 takes the call."""
    with FakeTensorMode():
        t = {"x": torch.empty(2, 64, 8, 16, device=CUDA),
             "weight": torch.empty(32, 64, 3, 3, device=CUDA),
             "bias": torch.empty(32, device=CUDA)}
        if needs_grad is not None:
            t[needs_grad].requires_grad_()

        def routes():
            return k4.routes(t["x"], t["weight"], t["bias"], (1, 1), (1, 1), (1, 1), 1)

        assert routes() is (needs_grad is None)
        with torch.no_grad():
            assert routes() is True


def test_training_forward_of_the_layer_keeps_cudnn(monkeypatch):
    """Conv2d with its parameters needing gradients: the forward is aten's
    convolution (cuDNN's forward, dgrad and wgrad on a card), not K4; under
    no_grad the same layer takes K4's route (opened here on the CPU as while
    tracing, so that it runs the op's plain version)."""
    monkeypatch.setattr(k4, "use_op", lambda x: True)
    layer = Conv2d(64, 32, 3, padding=1)
    x = torch.randn(2, 64, 8, 16, generator=torch.Generator().manual_seed(2))
    calls = k4.conv3x3_reference.calls
    out = layer(x)
    assert type(out.grad_fn).__name__ == "ConvolutionBackward0"
    assert k4.conv3x3_reference.calls == calls
    with torch.no_grad():
        got = layer(x)
    assert k4.conv3x3_reference.calls == calls + 1
    assert _rel(got, out.detach()) <= K1_REL


def test_fake_checks_what_the_kernel_takes():
    with FakeTensorMode():
        nhwc = (64 * 8 * 16, 1, 16 * 64, 64)  # channels_last strides
        x = torch.empty_strided((2, 64, 8, 16), nhwc, device=CUDA)
        w = torch.empty(128, 64, 3, 3, device=CUDA)
        y = torch.ops.srewd.conv3x3(x, w, torch.empty(128, device=CUDA))
        assert y.shape == (2, 128, 8, 16) and y.dtype == torch.float32
        assert y.is_contiguous(memory_format=torch.channels_last)
        bf16 = dict(device=CUDA, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="float32 only"):
            torch.ops.srewd.conv3x3(torch.empty_strided((2, 64, 8, 16), nhwc, **bf16),
                                    torch.empty(128, 64, 3, 3, **bf16), None)
        with pytest.raises(ValueError, match="Cout of 32"):
            torch.ops.srewd.conv3x3(x, torch.empty(48, 64, 3, 3, device=CUDA), None)
        with pytest.raises(ValueError, match="weight"):
            torch.ops.srewd.conv3x3(x, torch.empty(128, 32, 3, 3, device=CUDA), None)
    x, wt, b = _inputs(1, 16, 32, 4, 6)
    torch.testing.assert_close(torch.ops.srewd.conv3x3(x, wt, b), k4.conv3x3_reference(x, wt, b),
                               rtol=0, atol=0)


def test_exported_small_unet_holds_one_node_per_k4_call(tmp_path):
    """torch.export of a small UNet's sampler: one srewd::conv3x3 node per
    convolution K4 takes in a UNet call; the exported step, run on the CPU
    (the op's plain version), against the eager chain."""
    from srewd_tpu_torch.diffusion.schedule import Schedule
    from srewd_tpu_torch.serving.export import export_sampler, load_sampler, save_sampler

    cfg = {"architecture": "sr3",
           "unet": {"in_channel": 2, "out_channel": 1, "inner_channel": 32, "norm_groups": 8,
                    "channel_multiplier": [1, 2], "attn_res": [4], "res_blocks": 1,
                    "dropout": 0.0},
           "diffusion": {"image_height": 16, "image_width": 32, "image_channels": 1,
                         "channels": 1, "conditional": True}}
    torch.manual_seed(0)
    model = build_model(cfg)
    random_init_(model.unet, 0)
    sched = Schedule.from_config({"schedule": "linear", "n_timestep": 4, "linear_start": 1e-6,
                                  "linear_end": 1e-2})
    with torch.device("meta"):
        meta_model = build_model(cfg)
    want_nodes = len(_k4_calls(meta_model, 2, (4, 8)))
    assert want_nodes > 0
    ex = export_sampler(model, model.params(), sched, (4, 8, 1), device=torch.device("cpu"))
    nodes = [n for n in ex.step.graph.nodes if str(n.target) == "srewd.conv3x3.default"]
    assert len(nodes) == want_nodes
    path = str(tmp_path / "m.srexport")
    save_sampler(ex, path)
    lr = np.random.default_rng(0).standard_normal((2, 4, 8, 1)).astype(np.float32)
    got = load_sampler(path)(lr, seed=5).numpy()
    want = model.generate_sr({"LR": torch.from_numpy(lr)}, sched,
                             generator=torch.Generator().manual_seed(5)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


class _FakeLib:
    """The C entry point, recording its arguments."""

    def __init__(self):
        self.fwd = []

    def srewd_conv3x3_fwd(self, *args):
        self.fwd.append(args)
        return 0


def test_launches_counted_on_the_cuda_route(monkeypatch):
    """The CUDA route with the library mocked: one launch a call with
    conv3x3_plan's tiling; the raw weight handed over (to be split) on the
    first call and after the weight changes, its split kept otherwise."""
    lib = _FakeLib()
    monkeypatch.setattr(k4, "_library", lambda: lib)
    monkeypatch.setattr(k4, "use_plain", lambda x: False)
    monkeypatch.setattr(k4, "_sms", lambda index: k4.SMS)
    monkeypatch.setattr(k4, "launch", lambda device, fn, *args: fn(*args, 0))
    launches, splits = k4.conv3x3.launches, k4.conv3x3.weight_splits
    x, wt, b = _inputs(8, 512, 512, 8, 16)
    for _ in range(3):
        out = k4.conv3x3(x, wt, b)
    assert out.shape == (8, 512, 8, 16) and out.is_contiguous(memory_format=torch.channels_last)
    assert k4.conv3x3.launches - launches == 3 and len(lib.fwd) == 3
    assert k4.conv3x3.weight_splits - splits == 1
    # (x, raw weight or None, parts, bias, out, workspace, n, h, w, cin, cout, bn, splits, grid)
    assert lib.fwd[0][1] == wt.data_ptr() and lib.fwd[1][1] is None and lib.fwd[2][1] is None
    assert lib.fwd[0][2] == lib.fwd[2][2]  # the same kept split
    plan = k4.conv3x3_plan(8, 512, 512, 8, 16)
    assert lib.fwd[0][6:14] == (8, 8, 16, 512, 512, plan.bn, plan.splits, plan.grid)
    assert lib.fwd[0][5] is not None  # the split's workspace
    with torch.no_grad():
        wt.add_(1.0)  # a new version of the weight is split again
    k4.conv3x3(x, wt, None)
    assert k4.conv3x3.weight_splits - splits == 2
    assert lib.fwd[-1][1] == wt.data_ptr() and lib.fwd[-1][3] is None
