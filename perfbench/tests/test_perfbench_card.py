"""On the card: each cell's control, at the cell's own size, fails the
cell's limits (python3 -m pytest perfbench/tests/test_perfbench_card.py on
the chip; these skip without a card)."""

import pytest
import torch

from perfbench import cell as cells
from perfbench.controls import MODE


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("workload", ["phydiff-sample-f32", "srdiff-train-f32",
                                      "phydiff-serve-bf16", "srdiff-train-bf16"])
def test_the_control_fails_the_limits(card, workload):
    try:
        c = cells.find(workload)
    except KeyError:
        pytest.skip(f"{workload} is not in BENCHMARK.json")
    got = c.driver.control(c, seed=7, device=card, mode=MODE[c.traffic["dtype"]])
    assert any(v > c.limits["checks"][k] for k, v in got.items()), got
