"""Shared layers and random init of the frozen towers.

Counterpart of goi_tpu/query/_nn.py. The JAX package's towers read flat
``{"prefix.weight": array}`` dicts; here each tower is a tree of
``nn.Module``s whose ``state_dict()`` keys are exactly those names, so
the same dict (or the official checkpoint) loads with
``load_state_dict(strict=True)``. eps is required on the norms: each
architecture pins its own (1e-12 BERT, 1e-5 Swin/DINO, 1e-6 SAM).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def gelu(x: torch.Tensor) -> torch.Tensor:
    """erf-form GELU (torch.nn.functional.gelu's default)."""
    return F.gelu(x)


def linear(d_in: int, d_out: int, *, bias: bool = True,
           device="cuda") -> nn.Linear:
    """torch nn.Linear on the trailing dim; bias optional."""
    return nn.Linear(d_in, d_out, bias=bias, device=device)


def layer_norm(dim: int, *, eps: float, device="cuda") -> nn.LayerNorm:
    """torch nn.LayerNorm over the trailing dim."""
    return nn.LayerNorm(dim, eps=eps, device=device)


def group_norm(groups: int, channels: int, *, eps: float,
               device="cuda") -> nn.GroupNorm:
    """torch nn.GroupNorm on NCHW (groups capped at the channels, as the
    JAX package caps them)."""
    return nn.GroupNorm(min(groups, channels), channels, eps=eps,
                        device=device)


class MLP(nn.Module):
    """DETR / SAM MLP head: ``layers.{i}`` Linears, ReLU between them
    (ref:GroundingDINO/utils.py:171, segment_anything mask_decoder.py)."""

    def __init__(self, dims, device="cuda"):
        super().__init__()
        self.layers = nn.ModuleList(
            linear(a, b, device=device) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, lyr in enumerate(self.layers):
            x = lyr(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


def split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, T, C) -> (B, heads, T, C // heads)."""
    b, t, c = x.shape
    return x.reshape(b, t, heads, c // heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, heads, T, d) -> (B, T, heads * d)."""
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


def randn(shape, std: float, generator: torch.Generator) -> torch.Tensor:
    """Normal draws on the generator's device, times std."""
    return torch.randn(shape, generator=generator,
                       device=generator.device) * std


@torch.no_grad()
def init_by_rule_(module: nn.Module, generator: torch.Generator,
                  rule) -> nn.Module:
    """Overwrite every parameter of `module`, in sorted-name order, with
    ``rule(name, shape, generator)`` (a tensor on any device), as the JAX
    package's ``init_*_params`` walk their sorted shape tables."""
    for name, p in sorted(module.named_parameters()):
        p.copy_(rule(name, tuple(p.shape), generator))
    return module


def fan_in(shape) -> int:
    """The JAX init's fan: the last dim of a matrix, else all but the
    first dim."""
    return max(shape[-1] if len(shape) == 2 else math.prod(shape[1:]), 1)
