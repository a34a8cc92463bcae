"""Optimizable Semantic-space Hyperplane (OSH), inference half.

Counterpart of goi_tpu/query/osh.py: a linear decision over the
codebook feature space, initialized from the text embedding
(ref:networks.py:12-67). Reference quirks kept: bias init
2 - inverse_sigmoid(0.86) (ref:networks.py:18) and inputs scaled by
1/0.3438 (ref:networks.py:59). `osh_finetune` belongs to training and
is not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

INPUT_SCALE = 1.0 / 0.3438


@dataclasses.dataclass
class OSHState:
    weight: torch.Tensor  # (C,)
    bias: torch.Tensor    # ()


def osh_init(text_feat: torch.Tensor, set_bias: float = 0.86) -> OSHState:
    """Weight <- text embedding (ref:gui/main.py:1678-1680), bias <-
    2 - log(b/(1-b)) (ref:networks.py:18)."""
    weight = torch.as_tensor(text_feat, dtype=torch.float32)
    b = torch.tensor(set_bias, dtype=torch.float32, device=weight.device)
    return OSHState(weight=weight, bias=2.0 - torch.log(b / (1.0 - b)))


def osh_predict(state: OSHState, feats: torch.Tensor) -> torch.Tensor:
    """Raw decision value; positive = inside the query set
    (ref:networks.py:58-59)."""
    return (feats * INPUT_SCALE) @ state.weight + state.bias
