"""The float32 scheme of the attention kernels' tensor-core products, on the CPU.

K1 and K2 (srewd_tpu_torch/csrc/flash_attention*.cu) multiply float32
operands on the tensor cores by the 3xTF32 split of attention_mma.cuh: each
operand x = hi + lo with hi = cvt.rna.tf32.f32(x) and
lo = cvt.rna.tf32.f32(x - hi), and a*b ~ a_lo*b_hi + a_hi*b_lo + a_hi*b_hi.
This file emulates those products in numpy (TF32 rounding: nearest, ties
away from zero, 10 of float32's 23 mantissa bits kept; products and sums in
float64, which the tensor core's float32 accumulation does not beat) and
runs the kernels' algorithms on them: the forward with the unnormalised
probabilities divided by their row sum at the end, the backward with
P = exp(scale S - LSE) and Δ = rowsum(dO ∘ O). It shows that the split keeps
the results within chip_smoke.py's float32 tolerances of the plain versions
(K1 1e-5 · max(1, max|ref|), K2 1e-4 · max(1, max|ref|)), and that one-pass
TF32 does not: the tolerances rest on the split.
"""

import numpy as np
import pytest
import torch

from srewd_tpu_torch.ops.flash_attention import (attention_backward_reference,
                                                 attention_reference)

K1_REL = 1e-5
K2_REL = 1e-4
# (N, D) at the main path's head widths, small N to keep the file fast
SHAPES = [(256, 64), (64, 128), (32, 512)]


def tf32(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32: round float32 to 10 mantissa bits, to nearest,
    ties away from zero (adding half of the dropped range to the magnitude
    bits carries into the kept ones)."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def mm_3xtf32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a @ b of float32 operands by the 3xTF32 split, the small terms first."""
    a, b = a.astype(np.float32), b.astype(np.float32)
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    f = np.float64
    return (a_lo.astype(f) @ b_hi.astype(f) + a_hi.astype(f) @ b_lo.astype(f)
            + a_hi.astype(f) @ b_hi.astype(f))


def mm_tf32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a @ b with both operands rounded to TF32 once (one pass)."""
    return tf32(a).astype(np.float64) @ tf32(b).astype(np.float64)


def emulated_attention(mm, q, k, v, do, scale):
    """(o, dq, dk, dv) of the kernels' algorithms with products by `mm`,
    float32 values between the steps as the kernels keep them."""
    f32 = np.float32
    s = (mm(q, k.T) * scale).astype(f32)
    m = s.max(axis=1, keepdims=True)
    p = np.exp(s.astype(np.float64) - m).astype(f32)  # unnormalised
    l = p.astype(np.float64).sum(axis=1, keepdims=True)
    o = (mm(p, v) / l).astype(f32)
    lse = (m + np.log(l)).astype(f32)
    p = np.exp(s.astype(np.float64) - lse).astype(f32)
    dp = mm(do, v.T)
    delta = (do.astype(np.float64) * o).sum(axis=1, keepdims=True)
    ds = (p * (dp - delta) * scale).astype(f32)
    return o, mm(ds, k), mm(ds.T, q), mm(p.T, do)


def worst_errors(mm, n, d, seed=0):
    """{name: max |emulated - plain| / max(1, max|plain|)} for O, dQ, dK, dV."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((n, d)).astype(np.float32) for _ in range(4))
    scale = 1.0 / np.sqrt(d)
    got = emulated_attention(mm, q, k, v, do, scale)
    tq, tk, tv, tdo = (torch.from_numpy(x)[None] for x in (q, k, v, do))
    want = (attention_reference(tq, tk, tv, scale),
            *attention_backward_reference(tq, tk, tv, tdo, scale))
    errs = {}
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        w = w[0].double().numpy()
        errs[name] = float(np.abs(g - w).max() / max(1.0, np.abs(w).max()))
    return errs


def test_tf32_rounding_is_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)  # TF32's last kept bit at 1.0
    x = np.array([one + ulp / 2, one + ulp / 2 - np.float32(2.0 ** -23), -(one + ulp / 2),
                  one + ulp * 3 / 2, np.float32(3.0)], dtype=np.float32)
    np.testing.assert_array_equal(tf32(x), [one + ulp, one, -(one + ulp), one + 2 * ulp, 3.0])
    y = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    assert np.all(tf32(y).view(np.uint32) & np.uint32(0x1FFF) == 0)
    assert np.abs(tf32(y) - y).max() <= np.abs(y).max() * 2.0 ** -11


@pytest.mark.parametrize("n,d", SHAPES)
def test_3xtf32_stays_within_the_float32_tolerances(n, d):
    errs = worst_errors(mm_3xtf32, n, d)
    assert errs["o"] <= K1_REL, errs
    assert max(errs["dq"], errs["dk"], errs["dv"]) <= K2_REL, errs
    # float32-accurate: far inside both, ~1e-7
    assert max(errs.values()) < 1e-6, errs


@pytest.mark.parametrize("n,d", SHAPES)
def test_one_pass_tf32_does_not(n, d):
    errs = worst_errors(mm_tf32, n, d)
    assert errs["o"] > K1_REL, errs
    assert max(errs["dq"], errs["dk"], errs["dv"]) > K2_REL, errs
