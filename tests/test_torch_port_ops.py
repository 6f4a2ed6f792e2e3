"""The port's ops and diffusion math against the JAX package, on the CPU.

Inputs are made from a seed with numpy and go through both sides. On CPU
tensors the kernel wrappers take their plain PyTorch versions; the kernels
themselves are compared with those plain versions on the card by
chip_smoke.py.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srewd_tpu.diffusion import gaussian as jgauss
from srewd_tpu.diffusion.schedule import Schedule as JSchedule
from srewd_tpu.ops import finite_diff as jfd
from srewd_tpu.ops import resize as jresize
from srewd_tpu.ops import wavelets as jwave
from srewd_tpu.ops.flash_attention import flash_attention as jflash
from srewd_tpu.ops.pallas_fused import pallas_gn_swish_interpret
from srewd_tpu_torch.diffusion import gaussian as tgauss
from srewd_tpu_torch.diffusion.schedule import Schedule as TSchedule
from srewd_tpu_torch.ops import _build
from srewd_tpu_torch.ops import finite_diff as tfd
from srewd_tpu_torch.ops import reference_ops, resize as tresize, use_plain
from srewd_tpu_torch.ops import wavelets as twave
from srewd_tpu_torch.ops.flash_attention import (SUPPORTED_D, _check_qkv, attention_reference,
                                                 flash_attention)
from srewd_tpu_torch.ops.fused_groupnorm import (
    MAX_CLUSTER, MAX_THREADS, SMEM_LIMIT, gn_plan, gn_swish, gn_swish_reference)

# f32 elementwise ops and short sums: both sides round the same float32
# operations in a possibly different order, a few ulp of O(1) values.
ATOL_F32 = 1e-5


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("hw", [(8, 16), (32, 64)])
def test_bicubic_up4_matches_jax(hw):
    x = _rand((2, *hw, 1), 0)
    want = np.asarray(jresize.bicubic_up4(jnp.asarray(x)))
    got = tresize.bicubic_up4(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL_F32)
    np.testing.assert_array_equal(tresize.resize_matrix(hw[0], 4 * hw[0]),
                                  jresize.resize_matrix(hw[0], 4 * hw[0]))


def test_upsample_nearest2x_matches_jax():
    x = _rand((2, 4, 8, 3), 1)
    np.testing.assert_array_equal(
        tresize.upsample_nearest2x(torch.from_numpy(x)).numpy(),
        np.asarray(jresize.upsample_nearest2x(jnp.asarray(x))),
    )


@pytest.mark.parametrize("hw,levels", [((32, 64), 4), ((16, 32), 2)])
def test_haar_dwt_pyramid_matches_jax(hw, levels):
    x = _rand((2, *hw, 1), 2)
    want = jwave.haar_dwt_pyramid(jnp.asarray(x), levels=levels, combine="concat")
    got = twave.haar_dwt_pyramid(torch.from_numpy(x), levels=levels)
    assert len(got) == len(want) == levels
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL_F32)


def test_fd_stencils_matches_jax():
    x = _rand((2, 32, 64, 2), 3)
    np.testing.assert_allclose(
        tfd.fd_stencils(torch.from_numpy(x)).numpy(),
        np.asarray(jfd.fd_stencils(jnp.asarray(x))), atol=ATOL_F32,
    )


@pytest.mark.parametrize(
    "name", ["quad", "linear", "warmup10", "warmup50", "const", "jsd", "cosine"]
)
def test_schedule_constants_exact(name):
    # both sides compute in float64 numpy and round once to float32
    js = JSchedule.create(name, 100, 1e-6, 1e-2)
    ts = TSchedule.create(name, 100, 1e-6, 1e-2)
    assert ts.num_timesteps == js.num_timesteps
    for field in ("betas", "alphas_cumprod", "alphas_cumprod_prev",
                  "sqrt_alphas_cumprod_prev", "sqrt_recip_alphas_cumprod",
                  "sqrt_recipm1_alphas_cumprod", "posterior_variance",
                  "posterior_log_variance_clipped", "posterior_mean_coef1",
                  "posterior_mean_coef2"):
        np.testing.assert_array_equal(getattr(ts, field).numpy(),
                                      np.asarray(getattr(js, field)), err_msg=field)


@pytest.mark.parametrize("spacing", ["linspace", "trailing", "quad", "logsnr"])
@pytest.mark.parametrize("steps", [4, 50])
def test_select_taus_exact(spacing, steps):
    js = JSchedule.create("linear", 1000, 1e-6, 1e-2)
    ts = TSchedule.create("linear", 1000, 1e-6, 1e-2)
    np.testing.assert_array_equal(tgauss.select_taus(ts, steps, spacing),
                                  jgauss.select_taus(js, steps, spacing))


@pytest.mark.parametrize("n,d", [(256, 64), (64, 128)])
def test_attention_plain_matches_jax_kernel(n, d):
    q, k, v = (_rand((2, n, d), s) for s in (4, 5, 6))
    scale = 1.0 / math.sqrt(d)
    want = np.asarray(jflash(*(jnp.asarray(a) for a in (q, k, v)), scale, interpret=True))
    got = attention_reference(*(torch.from_numpy(a) for a in (q, k, v)), scale).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL_F32)


@pytest.mark.parametrize("swish", [True, False])
@pytest.mark.parametrize("shape,groups", [((2, 8, 16, 64), 32), ((2, 16, 8, 96), 32),
                                          ((1, 4, 4, 16), 8)])
def test_gn_swish_plain_matches_jax_kernel_f32(shape, groups, swish):
    c = shape[-1]
    x = _rand(shape, 7) * 3.0 + 1.0
    w, b = _rand((c,), 8), _rand((c,), 9)
    want = np.asarray(pallas_gn_swish_interpret(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), groups, 1e-5, swish))
    got = gn_swish_reference(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                             groups, 1e-5, swish).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL_F32)


@pytest.mark.parametrize("swish", [True, False])
def test_gn_swish_plain_matches_jax_kernel_bf16(swish):
    shape, groups = (2, 8, 16, 64), 32
    x = _rand(shape, 10) * 3.0 + 1.0
    w, b = _rand((64,), 11), _rand((64,), 12)
    xb = jnp.asarray(x, jnp.bfloat16)
    wb, bb = jnp.asarray(w, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    def jax_out(sw):
        return np.asarray(pallas_gn_swish_interpret(xb, wb, bb, groups, 1e-5, sw)
                          .astype(jnp.float32))

    want = jax_out(swish)
    to_t = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()  # noqa: E731
    got = gn_swish_reference(to_t(xb), to_t(wb), to_t(bb), groups, 1e-5, swish).float().numpy()
    # Compared in f32 within one bf16 ulp (8 significant bits) of the
    # normalised value y that enters the Swish. The statistics differ in
    # summation order, which can move y's rounding; the Pallas kernel takes
    # the Swish of the f32 y and rounds once, the plain version rounds y to
    # bf16 first. Near the Swish's zero the output is much smaller than y, so
    # a bound in the output's own ulp would not hold for either pair.
    y = jax_out(False)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(y), 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= ulp), np.max(np.abs(got - want) / ulp)


def test_gn_swish_plain_stats_match_jax():
    # the statistics the forward keeps for the backward: _pure_gn_swish's
    # float32 mean and E[x^2] - E[x]^2, as rsqrt(var + eps)
    shape, groups = (2, 8, 16, 96), 32
    x = _rand(shape, 15) * 3.0 + 1.0
    w, b = _rand((96,), 16), _rand((96,), 17)
    x32 = jnp.asarray(x).reshape(2, 8 * 16, groups, 96 // groups)
    mean = jnp.mean(x32, axis=(1, 3))
    var = jnp.mean(jnp.square(x32), axis=(1, 3)) - jnp.square(mean)
    _, got_mean, got_rstd = gn_swish_reference(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), groups, 1e-5, True,
        return_stats=True)
    assert got_mean.shape == got_rstd.shape == (2, groups) and got_mean.dtype == torch.float32
    np.testing.assert_allclose(got_mean.numpy(), np.asarray(mean), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_rstd.numpy(), np.asarray(jax.lax.rsqrt(var + 1e-5)),
                               rtol=1e-6, atol=1e-6)


# GroupNorm inputs [B, H, W, C] of one full-width phydiff UNet call at the
# sampling batch (8); training runs the same maps at batch 4.
GN_MAIN_PATH_SHAPES = [
    (8, 8, 16, 512), (8, 8, 16, 1024), (8, 16, 32, 256), (8, 16, 32, 512), (8, 16, 32, 768),
    (8, 16, 32, 1024), (8, 32, 64, 128), (8, 32, 64, 256), (8, 32, 64, 384), (8, 32, 64, 512),
    (8, 32, 64, 768), (8, 64, 128, 64), (8, 64, 128, 128), (8, 64, 128, 192),
    (8, 64, 128, 256), (8, 64, 128, 384), (8, 128, 256, 64), (8, 128, 256, 128),
    (8, 128, 256, 192),
]


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [8, 4])
def test_gn_plan_tiles_every_main_path_shape(batch, dtype, backward):
    isz = torch.empty((), dtype=dtype).element_size()
    for shape in GN_MAIN_PATH_SHAPES:
        b, h, w, c = (batch, *shape[1:])
        p = gn_plan((b, h, w, c), 32, dtype, backward)
        cg = c // 32
        # slices: whole groups that tile C exactly, 16-byte row segments of at
        # least one 32-byte sector, one channel per thread's sums
        assert p.slice_channels % cg == 0 and c % p.slice_channels == 0
        assert p.slices == c // p.slice_channels
        seg = p.slice_channels * isz
        assert seg % 16 == 0 and seg >= 32, (shape, p)
        assert p.threads % p.slice_channels == 0 and p.threads <= MAX_THREADS
        # rows: the cluster's blocks tile HW exactly, none empty
        assert p.rows_per_cta * p.cluster >= h * w > p.rows_per_cta * (p.cluster - 1)
        assert 1 <= p.cluster <= MAX_CLUSTER and p.cluster & (p.cluster - 1) == 0
        # x's slab (the backward also dy's) of rows x slice, 16-byte rounded,
        # then the float32 scratch
        slab = -(-p.rows_per_cta * seg // 16) * 16
        assert p.bytes_per_cta == (2 if backward else 1) * slab + 4 * (
            2 * p.threads + 10 * p.slice_channels)
        assert p.bytes_per_cta <= SMEM_LIMIT, (shape, p)
        assert p.blocks == b * p.slices * p.cluster


def test_gn_plan_refuses_what_no_cluster_holds():
    # 1024x1024 float32 maps of 64 channels: the narrowest slice (8 channels,
    # one 32-byte sector) is 32 MiB a sample, far past 16 x 227 KiB
    with pytest.raises(ValueError, match="16 CTAs x 227 KiB"):
        gn_plan((1, 1024, 1024, 64), 32, torch.float32)
    with pytest.raises(ValueError, match="not a multiple"):
        gn_plan((1, 8, 8, 60), 32, torch.float32)


def test_wrappers_take_plain_version_on_cpu():
    flash_attention.launches = gn_swish.launches = 0
    attention_reference.calls = gn_swish_reference.calls = 0
    q = torch.from_numpy(_rand((2, 64, 64), 13))
    x = torch.from_numpy(_rand((2, 4, 8, 64), 14))
    w, b = torch.ones(64), torch.zeros(64)
    torch.testing.assert_close(flash_attention(q, q, q, 0.125),
                               attention_reference(q, q, q, 0.125), rtol=0, atol=0)
    torch.testing.assert_close(gn_swish(x, w, b, 32), gn_swish_reference(x, w, b, 32),
                               rtol=0, atol=0)
    assert flash_attention.launches == 0 and gn_swish.launches == 0
    assert attention_reference.calls == 2 and gn_swish_reference.calls == 2


def test_plain_routing_rules():
    cpu = torch.zeros(1)
    assert use_plain(cpu)
    with reference_ops():
        assert use_plain(cpu)
    with pytest.raises(RuntimeError, match="no kernel for device"):
        use_plain(torch.zeros(1, device="meta"))


# The kernels copy q, k and v into shared memory 16 bytes at a time
# (cp.async): `_check_qkv` takes the main path's slab views and refuses a
# misaligned pointer or stride, with no copy.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", SUPPORTED_D)
def test_check_qkv_takes_the_main_path_slabs(d, dtype):
    qkv = torch.zeros(2, 3, 3 * d, dtype=dtype)  # SelfAttention's 1x1 qkv output
    _check_qkv("t", qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:])
    q, kv = torch.zeros(2, 3, d, dtype=dtype), torch.zeros(2, 3, 2 * d, dtype=dtype)
    _check_qkv("t", q, kv[..., :d], kv[..., d:])  # CrossAttention's q and kv slab


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_check_qkv_refuses_misaligned_views(dtype):
    d = 64
    ok = torch.zeros(2, 3, d, dtype=dtype)
    shifted = torch.zeros(2 * 3 * d + 1, dtype=dtype)[1:].view(2, 3, d)  # one element off
    with pytest.raises(ValueError, match="not 16-byte aligned"):
        _check_qkv("t", ok, shifted, ok)
    odd_rows = torch.zeros(2, 3, d + 1, dtype=dtype)[..., :d]  # row stride d + 1
    with pytest.raises(ValueError, match="not a multiple of 16 bytes"):
        _check_qkv("t", odd_rows, ok, ok)


def test_build_sources_are_the_three_kernels():
    # K1, K2 and K3 (forward and backward) are built from csrc/ by nvcc
    assert _build.SOURCES == ("flash_attention", "flash_attention_bwd", "gn_swish")
    for name in _build.SOURCES:
        assert os.path.exists(os.path.join(_build.CSRC_DIR, f"{name}.cu"))


def test_build_hash_covers_the_headers(tmp_path, monkeypatch):
    # an edited csrc/*.cuh must give a new library name, never a stale load
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    before = _build._paths("k")[1]
    (tmp_path / "h.cuh").write_text("// v2\n")
    assert _build._paths("k")[1] != before


def test_parse_ptxas_report():
    text = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'
ptxas info    : Function properties for _Z3fooPf
    0 bytes stack frame, 12 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 384 bytes cmem[0]
ptxas info    : Compiling entry function '_Z3barPf' for 'sm_90a'
ptxas info    : Function properties for _Z3barPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers, 1024 bytes smem, 360 bytes cmem[0]
"""
    assert _build.parse_ptxas(text) == [
        {"kernel": "_Z3fooPf", "registers": 168, "smem_static": 0, "spill_stores": 12,
         "spill_loads": 8, "stack": 0},
        {"kernel": "_Z3barPf", "registers": 32, "smem_static": 1024, "spill_stores": 0,
         "spill_loads": 0, "stack": 0},
    ]


def test_chip_smoke_kernel_names():
    import chip_smoke

    assert chip_smoke.kernel_name(
        "void <unnamed>::flash_fwd_kernel<float, (int)64, (int)4, (int)1, (int)64>"
        "(float const*, float*, int, <unnamed>::Strides, float)"
    ) == "flash_fwd_kernel<float, (int)64, (int)4, (int)1, (int)64>"
    assert chip_smoke.kernel_name(
        "void (anonymous namespace)::flash_bwd_delta_kernel<float>(float const*, float*, int)"
    ) == "flash_bwd_delta_kernel<float>"
    gn = [chip_smoke.kernel_name(n) for n in (
        "void <unnamed>::gn_fwd_kernel<__nv_bfloat16>(const T1 *, const T1 *, const T1 *, T1 *, "
        "float *, float *, int, int, int, int, int, int, float, int)",
        "void <unnamed>::gn_bwd_kernel<float>(const T1 *, const T1 *, const T1 *, const T1 *, "
        "const float *, const float *, T1 *, float *, int, int, int, int, int, int)",
        "<unnamed>::gn_wb_kernel(const float *, float *, float *, int, int)")]
    assert gn == ["gn_fwd_kernel<__nv_bfloat16>", "gn_bwd_kernel<float>", "gn_wb_kernel"]
    # GroupNorm has no product: phase 2 exempts its kernels (and K2's Δ) from
    # the tensor-core check, and holds every other K1/K2 kernel to it
    assert not any(chip_smoke.needs_hmma(n) for n in gn)
    assert not chip_smoke.needs_hmma("flash_bwd_delta_kernel<float>")
    assert chip_smoke.needs_hmma("flash_fwd_kernel<float, (int)64, (int)4, (int)1, (int)64>")
    assert chip_smoke.needs_hmma("flash_bwd_dq_kernel<float, (int)128>")


@pytest.mark.parametrize("fault", ["none", "differs_on_repeat", "nan"])
def test_chip_smoke_stress_watch_flags_a_faulty_kernel(monkeypatch, fault):
    """`chip_smoke.py --stress` wraps the kernel wrappers: each launch is
    made twice and held against its plain version. A stand-in K2 that
    repeats differently, or gives NaN, must be flagged; an exact one not;
    the wrapping must be undone afterwards."""
    import chip_smoke
    from srewd_tpu_torch.ops import flash_attention as fa

    calls = []

    def k2(q, k, v, o, lse, do, scale):
        calls.append(None)
        dq, dk, dv = fa.attention_backward_reference(q, k, v, do, scale)
        if fault == "differs_on_repeat":
            dq = dq + 1e-3 * len(calls)
        elif fault == "nan":
            dk = dk.clone()
            dk[0, 3, 5] = float("nan")
        return dq, dk, dv

    monkeypatch.setattr(fa, "flash_attention_backward", k2)
    log = {}
    unwrap = chip_smoke._watch_kernels(torch, log)
    try:
        g = torch.Generator().manual_seed(0)
        q, k, v, do = (torch.randn(2, 16, 64, generator=g) for _ in range(4))
        out = fa.flash_attention_backward(q, k, v, None, None, do, 0.125)
    finally:
        unwrap()
    assert fa.flash_attention_backward is k2
    assert len(calls) == 2 and len(out) == 3
    rec = log["flash_attention_backward"]
    assert rec["calls"] == 1
    assert rec["differ_on_repeat"] == (fault != "none")  # NaN != NaN as well
    assert rec["nonfinite"] == (fault == "nan")
    assert rec["over_tol"] == (fault == "differs_on_repeat")
    assert len(rec["bad"]) == (fault != "none")
