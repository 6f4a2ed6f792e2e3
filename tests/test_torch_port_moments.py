"""The kernel-moment ops, bilinear resampling and PhyConv against the JAX
package, on the CPU.

Inputs are seeded numpy values handed to both sides. Tolerances:
  * k2m, m2k and moment_constraint_loss: rtol 1e-5 (float32 contractions
    with the same float64-built matrices, summed in another order);
  * the derivative stencils: atol 1e-6, as tests/test_ops.py;
  * bilinear resize_matrix: atol 1e-7 (both build it in float64 and round
    once to float32: equal in practice);
  * PhyConv with JAX's params carried across by the bridge, float32:
    `out` and the moments within 1e-5 (relative to the largest magnitude),
    at 128x256 and at 32x64, where levels=4 leaves a 2x4 field that the
    5x5 stencil's reflect pad of 2 overruns (jnp.pad reflects again).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srewd_tpu.models.phy_conv import PhyConv as JaxPhyConv
from srewd_tpu.ops import moments as jmoments
from srewd_tpu.ops import resize as jresize
from srewd_tpu_torch.models import PhyConv
from srewd_tpu_torch.ops import k2m, m2k, moment_constraint_loss
from srewd_tpu_torch.ops import resize as tresize
from srewd_tpu_torch.ops.moments import _moment_matrices
from srewd_tpu_torch.utils.jax_params import (jax_tree_from_phy_conv_state,
                                              phy_conv_state_from_jax)

from test_torch_port_model import one_torch_thread  # noqa: F401

RTOL = 1e-5


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


KERNEL_SHAPES = [(5, 5), (3, 7), (4, 5, 5), (2, 3, 3, 3)]


@pytest.mark.parametrize("shape", KERNEL_SHAPES, ids=str)
def test_k2m_m2k_match_jax(shape):
    x = np.random.default_rng(len(shape)).standard_normal(shape).astype(np.float32)
    for port, jax_fn in ((k2m, jmoments.k2m), (m2k, jmoments.m2k)):
        got = port(torch.from_numpy(x)).numpy()
        want = np.asarray(jax_fn(jnp.asarray(x)))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("shape", KERNEL_SHAPES, ids=str)
def test_moment_round_trip(shape):
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(shape).astype(np.float32))
    np.testing.assert_allclose(m2k(k2m(x)).numpy(), x.numpy(), atol=1e-4)


def test_moment_matrices_are_jax_matrices():
    for shape in ((5, 5), (3, 7)):
        for got, want in zip(_moment_matrices(shape), jmoments._moment_matrices(shape)):
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)


def test_moment_constraint_loss_matches_jax():
    rng = np.random.default_rng(3)
    k = rng.standard_normal((3, 5, 5)).astype(np.float32)
    target = rng.standard_normal((3, 5, 5)).astype(np.float32)
    got = float(moment_constraint_loss(torch.from_numpy(k), torch.from_numpy(target)))
    want = float(jmoments.moment_constraint_loss(jnp.asarray(k), jnp.asarray(target)))
    assert got == pytest.approx(want, rel=RTOL)


def test_derivative_stencil_moments():
    """tests/test_ops.py's cases: the centred d/dx stencil has m[0, 1] = 1
    and the 5-point Laplacian m[2, 0] = m[0, 2] = 1, other low orders 0."""
    ddx = torch.tensor([[0, 0, 0], [-0.5, 0, 0.5], [0, 0, 0]], dtype=torch.float32)
    want = np.zeros((3, 3))
    want[0, 1] = 1.0
    np.testing.assert_allclose(k2m(ddx).numpy(), want, atol=1e-6)
    lap = torch.tensor([[0, 1, 0], [1, -4, 1], [0, 1, 0]], dtype=torch.float32)
    want = np.zeros((3, 3))
    want[2, 0] = want[0, 2] = 1.0
    np.testing.assert_allclose(k2m(lap).numpy(), want, atol=1e-6)


@pytest.mark.parametrize("n_in,n_out", [(128, 64), (9, 4), (2, 1), (16, 64), (5, 7)])
def test_bilinear_resize_matrix_matches_jax(n_in, n_out):
    got = tresize.resize_matrix(n_in, n_out, "bilinear")
    want = jresize.resize_matrix(n_in, n_out, "bilinear")
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    # the default stays bicubic
    np.testing.assert_array_equal(tresize.resize_matrix(n_in, n_out),
                                  jresize.resize_matrix(n_in, n_out, "bicubic"))


def test_bilinear_resize2d_matches_jax():
    x = np.random.default_rng(2).standard_normal((2, 32, 64, 3)).astype(np.float32)
    got = tresize.resize2d(torch.from_numpy(x), (16, 32), "bilinear").numpy()
    want = np.asarray(jresize.resize2d(jnp.asarray(x), (16, 32), "bilinear"))
    assert _rel(got, want) <= RTOL


def _jax_phy_conv(x):
    """JAX's PhyConv params, every leaf refilled with seeded values (the
    1x1 projection of weight scale), and its output on `x`."""
    mod = JaxPhyConv()
    shapes = jax.eval_shape(mod.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    rng = np.random.default_rng(11)
    params = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    out, mom = mod.apply({"params": params}, jnp.asarray(x))
    return params, np.asarray(out), np.asarray(mom)


@pytest.mark.parametrize("hw", [(128, 256), (32, 64)], ids=str)
def test_phy_conv_matches_jax(hw):
    x = np.random.default_rng(hw[0]).standard_normal((2, *hw, 2)).astype(np.float32)
    params, want_out, want_mom = _jax_phy_conv(x)
    port = PhyConv()
    port.load_state_dict(phy_conv_state_from_jax(params), strict=True)
    out, mom = port(torch.from_numpy(x))
    assert out.shape == want_out.shape == (2, hw[0] // 16, hw[1] // 16, 1)
    assert _rel(out.detach().numpy(), want_out) <= RTOL
    assert _rel(mom.detach().numpy(), want_mom) <= RTOL


def test_phy_conv_bridge_both_ways():
    params, _, _ = _jax_phy_conv(np.zeros((1, 32, 64, 1), np.float32))
    back = jax_tree_from_phy_conv_state(phy_conv_state_from_jax(params), like=params)
    assert jax.tree.structure(back) == jax.tree.structure(jax.tree.map(np.asarray, params))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    port = PhyConv()
    assert set(phy_conv_state_from_jax(params)) == set(port.state_dict())
    assert port.kernels.dtype == torch.float32 and tuple(port.kernels.shape) == (3, 5, 5)


def test_moment_loss_gradient_reaches_the_kernels():
    torch.manual_seed(0)
    port = PhyConv()
    out, mom = port(torch.randn(2, 32, 64, 1))
    target = torch.zeros_like(mom)
    target[:, 0, 1] = 1.0
    (out.square().mean() + moment_constraint_loss(port.kernels, target)).backward()
    assert port.kernels.grad is not None and bool(port.kernels.grad.abs().sum() > 0)
    assert torch.isfinite(port.kernels.grad).all()
