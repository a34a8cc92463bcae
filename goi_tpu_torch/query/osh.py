"""Optimizable Semantic-space Hyperplane (OSH).

Counterpart of goi_tpu/query/osh.py: a linear SVM over the codebook
feature space, initialized from the text embedding and fine-tuned with
a hinge loss against a 2D RES mask (ref:networks.py:12-67,
gui/main.py:1673-1763). Reference quirks kept:
  - bias init: 2 - inverse_sigmoid(0.86)          (ref:networks.py:18)
  - inputs scaled by 1/0.3438                     (ref:networks.py:59)
  - stop at IoU >= 0.9 or 8000 epochs             (ref:gui/main.py:1707-1763)
  - SGD lr = 0.01                                 (ref:networks.py:13,20)
Where the JAX package runs the fine-tune as one `lax.while_loop`, the
port runs it eagerly and tests the stop rule after every epoch, as the
loop's condition does: one host read of the IoU an epoch.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

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


def hinge_loss(outputs: torch.Tensor, labels01: torch.Tensor) -> torch.Tensor:
    """mean(clamp(1 - out * (2y-1), min=0)) (ref:networks.py:62-67), as
    torch.maximum: at a tie it passes half the gradient, as JAX's
    maximum does (clamp and relu pass all or none)."""
    y = 2.0 * labels01 - 1.0
    margin = 1.0 - outputs * y
    return torch.mean(torch.maximum(margin, torch.zeros_like(margin)))


def _iou(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    inter = torch.sum(pred & gt)
    union = torch.sum(pred | gt)
    return (inter / torch.clamp(union, min=1)).to(torch.float32)


def osh_finetune(
    state: OSHState,
    feats: torch.Tensor,     # (pixels, C) decoded codebook features
    mask: torch.Tensor,      # (pixels,) {0,1} RES supervision
    *,
    lr: float = 0.01,
    iou_target: float = 0.9,
    max_epochs: int = 8000,
) -> Tuple[OSHState, torch.Tensor, int]:
    """Full-batch SGD on the hinge loss until the IoU reaches its target
    or the epochs run out (ref:gui/main.py:1707-1763). Returns (state,
    iou (a 0-dim tensor), epochs run). The stop rule compares the IoU in
    float32, as the JAX loop's condition does."""
    mask = mask.to(torch.float32)
    gt = mask > 0
    weight = state.weight.detach().clone()
    bias = state.bias.detach().clone()
    with torch.no_grad():
        iou = _iou(osh_predict(state, feats) > 0, gt)
    epochs = 0
    while epochs < max_epochs and bool(iou < iou_target):
        weight.requires_grad_()
        bias.requires_grad_()
        loss = hinge_loss(osh_predict(OSHState(weight, bias), feats), mask)
        g_w, g_b = torch.autograd.grad(loss, (weight, bias))
        with torch.no_grad():
            weight = weight - lr * g_w
            bias = bias - lr * g_b
            iou = _iou(osh_predict(OSHState(weight, bias), feats) > 0, gt)
        epochs += 1
    return OSHState(weight=weight, bias=bias), iou, epochs
