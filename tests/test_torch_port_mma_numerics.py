"""The float32 scheme of the attention kernels' tensor-core products, on the CPU.

K1 and K2 (srewd_tpu_torch/csrc/flash_attention*.cu) multiply float32
operands on the tensor cores by the 3xTF32 split (attention_wgmma.cuh):
each operand x = hi + lo with hi = cvt.rna.tf32.f32(x) and
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


# ------------------------------------------------------------------ wgmma chains
#
# The wgmma design (attention_wgmma.cuh) issues every product as a chain of
# TF32 k-steps of 8 on the tensor cores: per k-step each of the three 3xTF32
# passes (a_lo b_hi, a_hi b_lo, a_hi b_hi, in that order, each operand split
# once: the B tiles pre-split, and for P V, P^T dO, dS^T Q and dS K
# transposed, in shared memory; P and dS in registers) adds its 8 products
# into the float32 accumulator, which the tensor cores round toward zero. A
# chain starts fresh (scale-d = 0) at every tile: S and dP run over the
# whole head width D (float32 at D >= 256: over 64-column chunks), each
# tile's P V (dV, dK, dQ) over the tile's keys (or queries) only, and the running sums are kept in float32 outside the tensor
# cores. The emulation below follows those chains with the tile sizes of the
# kernels' dispatch tables (the k index order inside a k-step, which the
# transposed tiles permute to match the register fragments, does not matter:
# a k-step's products are summed exactly here), and shows that the design
# stays within the tolerances at the four head widths, while a chain carried
# over all N keys, or one TF32 pass, does not.

# keys per K1 tile, queries per dK / dV tile, keys per dQ tile (the float32
# instantiations of the dispatch tables), and the columns of one S (and dP)
# chain (None: all of D; float32 at D >= 256 streams both operands in
# 64-column chunks and adds their products in float32). The backward at
# D >= 256 is the stream kernels' (the SREWD_K2_WIDE_WGMMA build); the
# default build keeps those widths on the mma.sync kernels, whose chains
# are shorter.
WGMMA_TILES = {64: (64, 32, 32, None), 128: (32, 16, 16, None), 256: (64, 32, 32, 64),
               512: (64, 32, 32, 64)}
CHAIN_SHAPES = [(256, 64), (64, 128), (64, 256), (32, 512)]


def rz32(x: np.ndarray) -> np.ndarray:
    """float64 to float32, rounded toward zero (the accumulator's add)."""
    f = np.asarray(x, np.float64).astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def three_x(a: np.ndarray, b: np.ndarray) -> list:
    """The 3xTF32 passes of a @ b in issue order, small terms first."""
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    return [(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)]


def one_pass(a: np.ndarray, b: np.ndarray) -> list:
    return [(tf32(a), tf32(b))]


def chain(passes: list, acc=None) -> np.ndarray:
    """acc + a @ b as one wgmma chain: k-steps of 8, each pass's 8 products
    summed exactly and added with truncation; acc None starts it fresh."""
    a0, b0 = passes[0]
    out = np.zeros((a0.shape[0], b0.shape[1]), np.float32) if acc is None else acc
    for k0 in range(0, a0.shape[1], 8):
        for a, b in passes:
            out = rz32(out.astype(np.float64)
                       + a[:, k0:k0 + 8].astype(np.float64) @ b[k0:k0 + 8].astype(np.float64))
    return out


def wgmma_forward(q, k, v, scale, bk, ops=three_x, one_chain=False, s_chunk=None):
    """(o, lse) of K1's wgmma design; `one_chain` carries O through one
    truncating chain over all keys (rescaled in place) instead of adding
    each tile's fresh chain in float32; `s_chunk` sums S over chunks of
    that many columns, each a fresh chain, in float32."""
    f32, f64 = np.float32, np.float64
    sl2 = f32(scale * np.log2(np.e))
    rows = q.shape[0]
    m = np.full((rows, 1), -np.inf, f32)
    l = np.zeros((rows, 1), f32)
    o = np.zeros((rows, v.shape[1]), f32)
    for k0 in range(0, k.shape[0], bk):
        kt, vt = k[k0:k0 + bk], v[k0:k0 + bk]
        cols = s_chunk or q.shape[1]
        s = np.zeros((rows, kt.shape[0]), f32)
        for c0 in range(0, q.shape[1], cols):
            s = (s.astype(f64) + chain(ops(q[:, c0:c0 + cols], kt[:, c0:c0 + cols].T))).astype(f32)
        s = s * sl2
        mx = np.maximum(m, s.max(axis=1, keepdims=True))
        alpha = np.exp2((m - mx).astype(f64)).astype(f32)
        m = mx
        p = np.exp2((s - m).astype(f64)).astype(f32)
        l = (l * alpha + p.sum(axis=1, keepdims=True, dtype=f64)).astype(f32)
        if one_chain:
            o = chain(ops(p, vt), acc=(o * alpha).astype(f32))
        else:
            o = (o.astype(f64) * alpha + chain(ops(p, vt))).astype(f32)
    lse = ((m + np.log2(l.astype(f64))) * np.log(2.0)).astype(f32)
    return (o / l).astype(f32), lse


def chunked(passes, a, b, cols):
    """a @ b, a fresh chain per `cols` columns of a (rows of b), the chains
    added in float32; cols None: one chain."""
    if cols is None:
        return chain(passes(a, b))
    out = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for c0 in range(0, a.shape[1], cols):
        out = (out.astype(np.float64)
               + chain(passes(a[:, c0:c0 + cols], b[c0:c0 + cols]))).astype(np.float32)
    return out


def wgmma_backward(q, k, v, do, o, lse, scale, bs, bq, ops=three_x, s_chunk=None):
    """(dq, dk, dv) of K2's wgmma design: dK / dV per streamed query tile of
    bs rows, dQ per streamed key tile of bq rows, each tile's product a fresh
    chain added in float32; `s_chunk` as in wgmma_forward, for S and dP."""
    f32, f64 = np.float32, np.float64
    sl2 = f32(scale * np.log2(np.e))
    lse2 = (lse * f32(np.log2(np.e))).astype(f32)[:, 0]
    delta = (do.astype(f64) * o).sum(axis=1).astype(f32)
    n = q.shape[0]
    dk, dv = np.zeros_like(k), np.zeros_like(v)
    for q0 in range(0, n, bs):
        qt, dot = q[q0:q0 + bs], do[q0:q0 + bs]
        st = chunked(ops, k, qt.T, s_chunk)
        pt = np.exp2((st * sl2 - lse2[q0:q0 + bs]).astype(f64)).astype(f32)
        dpt = chunked(ops, v, dot.T, s_chunk)
        dst = (pt * (dpt - delta[q0:q0 + bs]) * f32(scale)).astype(f32)
        dv = (dv.astype(f64) + chain(ops(pt, dot))).astype(f32)
        dk = (dk.astype(f64) + chain(ops(dst, qt))).astype(f32)
    dq = np.zeros_like(q)
    for k0 in range(0, n, bq):
        kt, vt = k[k0:k0 + bq], v[k0:k0 + bq]
        s = chunked(ops, q, kt.T, s_chunk)
        p = np.exp2((s * sl2 - lse2[:, None]).astype(f64)).astype(f32)
        ds = (p * (chunked(ops, do, vt.T, s_chunk) - delta[:, None]) * f32(scale)).astype(f32)
        dq = (dq.astype(f64) + chain(ops(ds, kt))).astype(f32)
    return dq, dk, dv


def wgmma_errors(n, d, ops=three_x, seed=0):
    """{name: max |emulated - plain| / max(1, max|plain|)} for O, LSE, dQ, dK, dV."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((n, d)).astype(np.float32) for _ in range(4))
    scale = 1.0 / np.sqrt(d)
    bk, bs, bq, s_chunk = WGMMA_TILES[d]
    o, lse = wgmma_forward(q, k, v, scale, bk, ops, s_chunk=s_chunk)
    got = (o, *wgmma_backward(q, k, v, do, o, lse, scale, bs, bq, ops, s_chunk))
    tq, tk, tv, tdo = (torch.from_numpy(x)[None] for x in (q, k, v, do))
    want = (attention_reference(tq, tk, tv, scale),
            *attention_backward_reference(tq, tk, tv, tdo, scale))
    errs = {}
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        w = w[0].double().numpy()
        errs[name] = float(np.abs(g - w).max() / max(1.0, np.abs(w).max()))
    s = (q.astype(np.float64) @ k.T.astype(np.float64)) * scale
    smax = s.max(axis=1, keepdims=True)
    ref_lse = smax + np.log(np.exp(s - smax).sum(axis=1, keepdims=True))
    errs["lse"] = float(np.abs(lse - ref_lse).max() / max(1.0, np.abs(ref_lse).max()))
    return errs


def test_rz32_rounds_toward_zero():
    x = np.array([1.0 + 2.0 ** -24, -(1.0 + 2.0 ** -24), 1.0 + 3 * 2.0 ** -24, 0.5], np.float64)
    np.testing.assert_array_equal(rz32(x), np.array([1.0, -1.0, 1.0 + 2.0 ** -23, 0.5],
                                                    np.float32))


@pytest.mark.parametrize("n,d", CHAIN_SHAPES)
def test_wgmma_chains_stay_within_the_float32_tolerances(n, d):
    errs = wgmma_errors(n, d)
    assert errs["o"] <= K1_REL, errs
    assert errs["lse"] <= 1e-4, errs
    assert max(errs["dq"], errs["dk"], errs["dv"]) <= K2_REL, errs


@pytest.mark.parametrize("n,d", CHAIN_SHAPES)
def test_wgmma_chains_one_pass_tf32_do_not(n, d):
    errs = wgmma_errors(n, d, ops=one_pass)
    assert errs["o"] > K1_REL, errs
    assert max(errs["dq"], errs["dk"], errs["dv"]) > K2_REL, errs


def test_wgmma_one_chain_over_all_keys_does_not():
    """P V carried through one truncating chain over N=4096 keys drifts past
    K1's tolerance (the truncations' bias adds up with the sum), where the
    design's fresh chain per key tile, added in float32, does not. V has a
    mean of 1, so every row's running sum grows steadily, as a softmax over
    a field that is not centred makes it; 16 query rows are enough."""
    rng = np.random.default_rng(1)
    n, d, rows = 4096, 64, 16
    q = rng.standard_normal((rows, d)).astype(np.float32)
    k = rng.standard_normal((n, d)).astype(np.float32)
    v = (1.0 + 0.25 * rng.standard_normal((n, d))).astype(np.float32)
    scale = 1.0 / np.sqrt(d)
    want = attention_reference(*(torch.from_numpy(x)[None] for x in (q, k, v)), scale)[0].numpy()
    tol = K1_REL * max(1.0, np.abs(want).max())
    bk = WGMMA_TILES[d][0]
    tiled, _ = wgmma_forward(q, k, v, scale, bk)
    carried, _ = wgmma_forward(q, k, v, scale, bk, one_chain=True)
    assert np.abs(tiled - want).max() <= tol
    assert np.abs(carried - want).max() > tol
