"""On the card: a leaf drawn into one layer of a stacked program tensor
holds the same values as the leaf the reference draws afresh, bit for bit,
in bf16 (the check rests on it)."""
import pathlib
import sys

import pytest
import torch

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

from hbench import inputs  # noqa: E402


@pytest.mark.cuda
def test_a_layer_drawn_in_place_equals_one_drawn_afresh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    stacked = torch.empty((3, 1, 256, 1024), dtype=torch.bfloat16,
                          device="cuda")
    for i in range(3):
        inputs.draw_(stacked[i, 0], 2 ** 31 + 5, "moe_w1", i, 0.0, 0.03)
    for i in range(3):
        fresh = inputs.draw((256, 1024), 2 ** 31 + 5, "moe_w1", i, 0.0, 0.03,
                            torch.bfloat16, "cuda")
        assert torch.equal(stacked[i, 0], fresh)
    assert not torch.equal(stacked[0, 0], stacked[1, 0])
