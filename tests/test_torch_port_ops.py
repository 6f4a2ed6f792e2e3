"""The port's ops and diffusion math against the JAX package, on the CPU.

Inputs are made from a seed with numpy and go through both sides. On CPU
tensors the kernel wrappers take their plain PyTorch versions; the kernels
themselves are compared with those plain versions on the card by
chip_smoke.py.
"""

import math

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
from srewd_tpu_torch.ops import finite_diff as tfd
from srewd_tpu_torch.ops import reference_ops, resize as tresize, use_plain
from srewd_tpu_torch.ops import wavelets as twave
from srewd_tpu_torch.ops.flash_attention import attention_reference, flash_attention
from srewd_tpu_torch.ops.fused_groupnorm import gn_swish, gn_swish_reference

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
