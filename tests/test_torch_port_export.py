"""The port's exported sampler on the CPU (serving/export.py): against the
JAX package's export_sampler/load_sampler, against the port's own
generate_sr, loaded without model code, and K1's and K3's forwards as
torch.library custom ops in the exported graph.

Toy width as tests/test_torch_port_serving.py (inner 8, 16x32 fields).
On the CPU the custom ops' CPU implementations are the plain versions;
their fakes run the CUDA checks for tensors on a card (FakeTensorMode).
"""

import os
import subprocess
import sys
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from srewd_tpu.data.scalers import MonthlyScalerSet as JScalers
from srewd_tpu.diffusion.schedule import Schedule as JSchedule
from srewd_tpu.ops.resize import bicubic_up4 as jax_bicubic_up4
from srewd_tpu.serving import export as jexport
from srewd_tpu_torch.data.scalers import MonthlyScalerSet
from srewd_tpu_torch.diffusion.schedule import Schedule
from srewd_tpu_torch.ops import flash_attention as fa
from srewd_tpu_torch.ops import fused_groupnorm as gn
from srewd_tpu_torch.serving.export import export_sampler, load_sampler, save_sampler

from test_torch_port_model import (  # noqa: F401  (one_torch_thread: autouse)
    _jax_noise, one_torch_thread, rel_rmse)
from test_torch_port_serving import LH, LW, H, W, _lr, make_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
DDPM8 = {"schedule": "linear", "n_timestep": 8, "linear_start": 1e-6, "linear_end": 1e-2}
T1000 = {"schedule": "linear", "n_timestep": 1000, "linear_start": 1e-6, "linear_end": 1e-2}
SAMPLERS = {
    "ddpm": (DDPM8, {}, 8),  # (schedule, sampler_kwargs, noises the JAX chain draws)
    "ddim": (T1000, {"sampler": "ddim", "ddim_steps": 4, "ddim_eta": 1.0}, 4),
    "dpm": (T1000, {"sampler": "dpm", "ddim_steps": 4}, 4),
}


def _kelvin_scalers():
    mean = np.zeros((13, 1, 1, 1), np.float32)
    std = np.ones((13, 1, 1, 1), np.float32)
    mean[3], std[3] = 280.0, 12.0
    mean[4], std[4] = 275.0, 9.0
    return mean, std


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """artifact(arch, sampler) -> (port model, ExportedSampler, path): one
    symbolic-batch export per pair for the whole module."""
    cache = {}

    def get(arch, sampler):
        if (arch, sampler) not in cache:
            _, _, port = make_pair(arch)
            ex, path = _export_port(port, tmp_path_factory.mktemp(f"{arch}_{sampler}"),
                                    *SAMPLERS[sampler][:2])
            cache[arch, sampler] = (port, ex, path)
        return cache[arch, sampler]

    return get


def _export_port(port, tmp_path, sched_cfg, skw, name="m.srexport", **kw):
    ex = export_sampler(port, port.params(), Schedule.from_config(sched_cfg), (LH, LW, 1),
                        sampler_kwargs=skw, device=CPU, **kw)
    path = str(tmp_path / name)
    save_sampler(ex, path)
    return ex, path


@pytest.mark.parametrize("arch,sampler", [("sr3", "ddpm"), ("phydiff", "ddim")])
def test_artifact_matches_jax_artifact_two_batches_kelvin(arch, sampler, tmp_path):
    """One symbolic-batch artifact each side, Kelvin scalers baked in, batch
    sizes 2 and 5, the port fed the JAX artifact's draws for its seed:
    relative RMSE <= 1e-3 per field in normalized space, of the chain's own
    output (test_generate_sr_matches_jax's bound)."""
    jmodel, tree, port = make_pair(arch)
    sched_cfg, skw, n_noise = SAMPLERS[sampler]
    mean, std = _kelvin_scalers()
    jlr, jhr = (JScalers(mean, std, "GlobalStandardScaling"),
                JScalers(mean + 1.0, std * 2.0, "GlobalStandardScaling"))
    lr_sc, hr_sc = (MonthlyScalerSet(s.mean, s.std, "GlobalStandardScaling") for s in (jlr, jhr))
    jex = jexport.export_sampler(jmodel, tree, JSchedule.from_config(sched_cfg), (LH, LW, 1),
                                 sampler_kwargs=skw, lr_scaler=jlr, hr_scaler=jhr)
    jexport.save_sampler(jex, str(tmp_path / "j.srexport"))
    jfn = jexport.load_sampler(str(tmp_path / "j.srexport"))
    _, path = _export_port(port, tmp_path, sched_cfg, skw, lr_scaler=lr_sc, hr_scaler=hr_sc)
    fn = load_sampler(path)
    header = fn.exported.header
    assert header["batch"] == "symbolic" and header["kelvin"] == {"lr": True, "hr": True}
    for b, seed in ((2, 7), (5, 9)):
        months = np.array([3, 4, 3, 4, 3][:b], np.int32)
        lr_k = lr_sc.inverse(_lr(b, seed=b), months)
        want = np.asarray(jfn(lr_k, months, seed=seed))
        init, noises = _jax_noise(jax.random.key(jnp.uint32(seed)), (b, H, W, 1), n_noise)
        got = fn(lr_k, months, init=init, noises=noises).numpy()
        assert got.shape == want.shape == (b, H, W, 1)
        cond = (np.asarray(jax_bicubic_up4(jnp.asarray(lr_sc.transform(lr_k, months))))
                if arch != "sr3" else 0.0)
        gn_, wn = hr_sc.transform(got, months) - cond, hr_sc.transform(want, months) - cond
        for i in range(b):
            assert rel_rmse(gn_[i], wn[i]) <= 1e-3, (b, i)


@pytest.mark.parametrize("arch,sampler", [("sr3", "ddpm"), ("sr3", "ddim"), ("phydiff", "dpm")])
def test_artifact_equals_generate_sr_for_a_seed(arch, sampler, artifact):
    """fn(lr, seed=s) against generate_sr(generator=manual_seed(s)) at two
    batch sizes of one artifact: atol 1e-5, the JAX test's."""
    port, _, path = artifact(arch, sampler)
    sched_cfg, skw, _ = SAMPLERS[sampler]
    fn = load_sampler(path)
    for b, seed in ((2, 7), (5, 9)):
        lr = _lr(b, seed=b)
        got = fn(lr, seed=seed).numpy()
        want = port.generate_sr({"LR": torch.from_numpy(lr)}, Schedule.from_config(sched_cfg),
                                generator=torch.Generator().manual_seed(seed), **skw).numpy()
        assert got.shape == (b, H, W, 1)
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_static_batch_export_refuses_other_sizes(tmp_path):
    _, _, port = make_pair("sr3")
    _, path = _export_port(port, tmp_path, DDPM8, {}, symbolic_batch=False, batch_size=3)
    fn = load_sampler(path)
    assert fn.exported.header["batch"] == 3
    assert fn(_lr(3, seed=2), seed=0).shape == (3, H, W, 1)
    with pytest.raises(Exception):
        fn(_lr(2, seed=2), seed=0)


def test_keep_every_rejected():
    _, _, port = make_pair("sr3")
    with pytest.raises(ValueError, match="keep_every"):
        export_sampler(port, port.params(), Schedule.from_config(DDPM8), (LH, LW, 1),
                       sampler_kwargs={"keep_every": 2})


def test_artifact_loads_and_runs_without_model_code(artifact):
    _, _, path = artifact("phydiff", "dpm")
    code = (
        "import sys, numpy as np\n"
        "from srewd_tpu_torch.serving.export import load_sampler\n"
        f"fn = load_sampler({path!r})\n"
        f"sr = fn(np.zeros((3, {LH}, {LW}, 1), np.float32), seed=1)\n"
        "assert sr.shape == (3, 16, 32, 1) and bool(sr.isfinite().all()), sr.shape\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'srewd_tpu') or m in (\n"
        "    'srewd_tpu_torch.models', 'srewd_tpu_torch.configs', 'srewd_tpu_torch.diffusion',\n"
        "    'srewd_tpu_torch.training', 'srewd_tpu_torch.cli', 'srewd_tpu_torch.data')]\n"
        "print(sorted(bad))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"


def _count_plain_calls(fn):
    fa.attention_reference.calls = gn.gn_swish_reference.calls = 0
    fn()
    return fa.attention_reference.calls, gn.gn_swish_reference.calls


@pytest.mark.parametrize("arch,sampler", [("sr3", "ddpm"), ("phydiff", "dpm")])
def test_step_graph_holds_one_op_node_per_kernel_call(arch, sampler, artifact):
    """The step program calls srewd::flash_attention and srewd::gn_swish as
    often as one eager UNet call calls K1 and K3, with the kernels' layouts
    (unit stride along D and 16-byte strides; NHWC-contiguous GN input);
    on the CPU the op runs the plain version and launches no kernel."""
    port, ex, path = artifact(arch, sampler)
    nodes = [n for n in ex.step.graph.nodes if n.op == "call_function"
             and str(n.target).startswith("srewd.")]
    counts = Counter(str(n.target) for n in nodes)
    unet = port._chain_unet()
    lr = torch.from_numpy(_lr(2))
    cond, consts = port.chain_conditioning({"LR": lr}, unet)
    k1, k3 = _count_plain_calls(lambda: port.chain_eps(unet, cond, consts, cond,
                                                        torch.full((2,), 0.5)))
    assert k1 > 0 and k3 > 0
    assert counts == {"srewd.flash_attention.default": k1, "srewd.gn_swish.default": k3}
    for n in nodes:
        vals = [a.meta["val"] for a in n.args if hasattr(a, "meta")]
        if "flash_attention" in str(n.target):
            for t in vals:
                assert t.stride(2) == 1
                assert all(t.stride(d) * t.element_size() % 16 == 0 for d in (0, 1))
        else:
            assert vals[0].is_contiguous()
    launches = (fa.flash_attention.launches, gn.gn_swish.launches)
    fn = load_sampler(path)
    loaded = Counter(str(n.target) for n in fn.exported.step.graph.nodes
                     if str(n.target).startswith("srewd."))
    assert loaded == counts  # the saved program keeps its op nodes
    k1_run, k3_run = _count_plain_calls(lambda: fn(_lr(2), seed=0))
    steps = fn.exported.header["steps"]
    assert (k1_run, k3_run) == (steps * k1, steps * k3)
    assert (fa.flash_attention.launches, gn.gn_swish.launches) == launches


def test_custom_op_fakes_run_the_cuda_checks():
    """On fake CUDA tensors: output shape and dtype of the kernel's; an
    unsupported D, dtype or layout raises while tracing."""
    cuda = torch.device("cuda")
    with FakeTensorMode():
        # q, k, v as SelfAttention slices them from one [B, N, 3D] slab
        q, k, v = (torch.empty_strided((2, 128, 64), (128 * 192, 192, 1), device=cuda)
                   for _ in range(3))
        o = torch.ops.srewd.flash_attention(q, k, v, 0.125)
        assert o.shape == (2, 128, 64) and o.dtype == torch.float32 and o.is_contiguous()
        with pytest.raises(ValueError, match="supports D"):
            torch.ops.srewd.flash_attention(*(torch.empty(2, 128, 48, device=cuda),) * 3, 1.0)
        with pytest.raises(ValueError, match="dtype"):
            torch.ops.srewd.flash_attention(
                *(torch.empty(2, 128, 64, device=cuda, dtype=torch.float16),) * 3, 1.0)
        odd = torch.empty_strided((2, 128, 64), (128 * 65, 65, 1), device=cuda)
        with pytest.raises(ValueError, match="multiple of 16 bytes"):
            torch.ops.srewd.flash_attention(odd, odd, odd, 1.0)
        bf16 = dict(device=cuda, dtype=torch.bfloat16)
        x = torch.empty(2, 16, 32, 64, **bf16)
        w = torch.empty(64, **bf16)
        y = torch.ops.srewd.gn_swish(x, w, w, 32, 1e-5, True)
        assert y.shape == x.shape and y.dtype == torch.bfloat16 and y.is_contiguous()
        half = dict(device=cuda, dtype=torch.float16)
        with pytest.raises(ValueError, match="float32 and bfloat16"):
            torch.ops.srewd.gn_swish(torch.empty(2, 16, 32, 64, **half),
                                     torch.empty(64, **half), torch.empty(64, **half), 32,
                                     1e-5, True)
        nchw = torch.empty_strided((2, 16, 32, 64), (16 * 32 * 64, 1, 16 * 64, 32), **bf16)
        with pytest.raises(ValueError, match="NHWC-contiguous"):
            torch.ops.srewd.gn_swish(nchw, w, w, 32, 1e-5, True)
        w32 = torch.empty(64, device=cuda)
        with pytest.raises(ValueError, match="x's dtype"):
            torch.ops.srewd.gn_swish(x, w32, w32, 32, 1e-5, True)


def test_op_cpu_route_is_the_plain_version():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 12, 16, generator=g) for _ in range(3))
    np.testing.assert_array_equal(torch.ops.srewd.flash_attention(q, k, v, 0.25),
                                  fa.attention_reference(q, k, v, 0.25))
    x = torch.randn(2, 4, 8, 16, generator=g)
    w, b = torch.randn(16, generator=g), torch.randn(16, generator=g)
    np.testing.assert_array_equal(torch.ops.srewd.gn_swish(x, w, b, 4, 1e-5, True),
                                  gn.gn_swish_reference(x, w, b, 4, 1e-5, True))
