"""The control on the card: the plain reference put in the program's
place and computed in TF32 (and, for the distillation cells, with half
of each view's pixels left out of the loss) must fail the cell's own
comparison at the cell's own size. Skips without a card."""

import json
from pathlib import Path

import pytest
import torch

from portbench import control

PB = Path(__file__).resolve().parents[1]
CASES = [("scannet-1m.distill", "tf32"), ("scannet-1m.distill", "half_batch"),
         ("scannet-1m.query", "tf32"), ("m360-garden.distill", "tf32")]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's "
                    "own size on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell,mode", CASES)
def test_control_fails_the_comparison(card, cell, mode):
    limits = json.loads((PB / "workloads" / f"{cell}.json").read_text())[
        "limits"]
    nums = control.readings(cell, 4_000_000_007, mode)
    _, ok = control.program.checks(nums, limits)
    assert not ok, nums
