"""The operation and byte counts of the kernels."""

import pytest

from perfbench import work


def test_attention_counts():
    calls = [("attention", {"b": 8, "n": 512, "d": 512, "dtype": None})]
    w = work.kernel_work(calls, "float32", backward=True)
    assert w["k1"] == (4.0 * 8 * 512 ** 2 * 512, 4.0 * 8 * 512 * 512 * 4)
    assert w["k2"][0] == 10.0 * 8 * 512 ** 2 * 512
    assert w["k2"][1] == (7.0 * 4 + 4.0) * 8 * 512 * 512 + 4.0 * 8 * 512


def test_group_norm_counts_bytes():
    e, c = 8 * 64 * 128 * 256, 64
    w = work.kernel_work([("group_norm", {"numel": e, "c": c, "swish": True, "dtype": None})],
                         "bfloat16", backward=True)
    assert w["k3"] == (10.0 * e, 2.0 * e * 2 + 2 * c * 4)
    assert w["k3_bwd"] == (20.0 * e, 3.0 * e * 2 + 4 * c * 4)
    b = work.kernel_bound_seconds(w, "bfloat16")
    assert b["k3"] == pytest.approx(w["k3"][1] / work.HBM)  # bound by bytes


def test_bound_takes_the_larger_side():
    assert work.bound_seconds(1e12, 0, 1e12) == 1.0
    assert work.bound_seconds(0, work.HBM, 1e12) == 1.0


def test_reference_call_shapes_of_a_phydiff_unet_call():
    from perfbench import cell as cells

    c = cells.find("phydiff-sample-f32")
    u = work.sample_unit(c.config["model"], 8)
    kinds = [k for k, _ in u["calls"]]
    assert kinds.count("attention") == 10 and kinds.count("group_norm") == 65
    assert u["flops"] > 1e12
