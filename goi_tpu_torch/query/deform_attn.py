"""Multi-scale deformable attention.

Counterpart of goi_tpu/query/deform_attn.py: the vendored GroundingDINO
CUDA op (ref:ext/GroundingDINO/groundingdino/models/GroundingDINO/csrc/
and the module wrapper ms_deform_attn.py:136-345). In the JAX package
this is XLA (a gather and a bilinear lerp), reached by no Pallas kernel,
so here it is torch ops: four row gathers per level from the
level-flattened (B*heads, H*W, d) values.

Semantics of Deformable DETR (arXiv:2010.04159):
- sampling locations are normalized to [0, 1] per level, pixel centres
  at (i + 0.5) / size, and a sample outside the level reads zeros
  (grid_sample with align_corners=False, padding_mode="zeros");
- attention weights are a softmax over (levels x points) per
  (query, head).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from goi_tpu_torch.query._nn import linear
from goi_tpu_torch.utils.profiling import armed, count, span


def bilinear_sample(value: torch.Tensor, loc: torch.Tensor) -> torch.Tensor:
    """Sample `value` (B, H, W, C) at `loc` (B, Q, P, 2), normalized
    [0, 1] (x, y) coords with pixel centres at (i+0.5)/size and zeros
    outside: F.grid_sample(..., align_corners=False,
    padding_mode="zeros") at grid 2*loc-1. Returns (B, Q, P, C)."""
    b, h, w, c = value.shape
    x = loc[..., 0] * w - 0.5
    y = loc[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = x0.long()
    y0i = y0.long()
    flat = value.reshape(b, h * w, c)

    def corner(xi, yi):
        ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        v = torch.gather(flat, 1, idx.reshape(b, -1, 1).expand(-1, -1, c))
        return torch.where(ok[..., None], v.reshape(idx.shape + (c,)), 0.0)

    top = corner(x0i, y0i) * (1 - fx) + corner(x0i + 1, y0i) * fx
    bot = corner(x0i, y0i + 1) * (1 - fx) + corner(x0i + 1, y0i + 1) * fx
    return top * (1 - fy) + bot * fy


def ms_deform_attn_core(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """The core op (the CUDA `ms_deform_attn_forward`).

    value: (B, sum(H*W), n_heads, d_head), levels concatenated.
    spatial_shapes: ((H0, W0), (H1, W1), ...).
    sampling_locations: (B, Q, n_heads, n_levels, n_points, 2) in [0,1].
    attention_weights: (B, Q, n_heads, n_levels, n_points), normalized.
    Returns (B, Q, n_heads * d_head)."""
    b, _, n_heads, d = value.shape
    q = sampling_locations.shape[1]
    with span("deform_attn"):
        if armed():
            count("deform.samples",
                  b * q * n_heads * len(spatial_shapes)
                  * sampling_locations.shape[4])
        out = torch.zeros((b * n_heads, q, d), dtype=value.dtype,
                          device=value.device)
        start = 0
        for lvl, (hh, ww) in enumerate(spatial_shapes):
            v = value[:, start:start + hh * ww]            # (B, HW, h, d)
            start += hh * ww
            v = v.transpose(1, 2).reshape(b * n_heads, hh, ww, d)
            loc = sampling_locations[:, :, :, lvl]         # (B, Q, h, P, 2)
            p = loc.shape[3]
            loc = loc.transpose(1, 2).reshape(b * n_heads, q, p, 2)
            wgt = attention_weights[:, :, :, lvl].transpose(1, 2) \
                .reshape(b * n_heads, q, p, 1)
            out = out + (bilinear_sample(v, loc) * wgt).sum(2)
        return out.reshape(b, n_heads, q, d).transpose(1, 2) \
            .reshape(b, q, n_heads * d)


def sampling_locations(ref_points: torch.Tensor, off: torch.Tensor,
                       spatial_shapes: Sequence[Tuple[int, int]],
                       n_points: int) -> torch.Tensor:
    """Reference points (B, Q, L, 2) centres or (B, Q, L, 4) boxes plus
    offsets (B, Q, heads, L, P, 2) -> locations in [0, 1]
    (ref:ms_deform_attn.py:316-334)."""
    if ref_points.shape[-1] == 2:
        norm = torch.tensor([(w_, h_) for (h_, w_) in spatial_shapes],
                            dtype=torch.float32, device=off.device)
        return ref_points[:, :, None, :, None, :] \
            + off / norm[None, None, None, :, None, :]
    return ref_points[:, :, None, :, None, :2] \
        + off / n_points * ref_points[:, :, None, :, None, 2:] * 0.5


def init_deform_attn(generator: torch.Generator, embed_dim: int = 256,
                     n_heads: int = 8, n_levels: int = 4,
                     n_points: int = 4) -> dict:
    """Parameters of the full module with the reference init, on the
    generator's device: sampling offsets start as a per-head compass
    rose scaled by point index, attention weights at zero (a uniform
    softmax), xavier projections (ref:ms_deform_attn.py:198-221).
    Weights are (in, out), as the JAX package lays them out."""
    dev = generator.device
    thetas = np.arange(n_heads, dtype=np.float32) * (2 * math.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, n_levels, n_points, 1))
    grid *= np.arange(1, n_points + 1, dtype=np.float32)[None, None, :, None]

    def xavier(shape):
        lim = math.sqrt(6.0 / (shape[0] + shape[1]))
        return torch.rand(shape, generator=generator, device=dev) \
            * (2 * lim) - lim

    n = n_heads * n_levels * n_points
    return {
        "sampling_offsets": {
            "w": torch.zeros((embed_dim, 2 * n), device=dev),
            "b": torch.as_tensor(grid.reshape(-1), device=dev)},
        "attention_weights": {"w": torch.zeros((embed_dim, n), device=dev),
                              "b": torch.zeros((n,), device=dev)},
        "value_proj": {"w": xavier((embed_dim, embed_dim)),
                       "b": torch.zeros((embed_dim,), device=dev)},
        "output_proj": {"w": xavier((embed_dim, embed_dim)),
                        "b": torch.zeros((embed_dim,), device=dev)},
    }


def deform_attn(
    params: dict,
    query: torch.Tensor,
    value: torch.Tensor,
    reference_points: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    *,
    n_heads: int = 8,
    n_points: int = 4,
    query_pos: torch.Tensor = None,
    key_padding_mask: torch.Tensor = None,
) -> torch.Tensor:
    """The full MultiScaleDeformableAttention forward, batch-first, on
    `init_deform_attn`'s (in, out) parameters
    (ref:ms_deform_attn.py:232-345).

    query: (B, Q, E); value: (B, sum(HW), E);
    reference_points: (B, Q, n_levels, 2) normalized centres or
    (B, Q, n_levels, 4) normalized (cx, cy, w, h) boxes;
    key_padding_mask: (B, sum(HW)) True = ignore. Returns (B, Q, E)."""
    n_levels = len(spatial_shapes)
    b, q, e = query.shape
    if query_pos is not None:
        query = query + query_pos

    def lin(name, x):
        return x @ params[name]["w"] + params[name]["b"]

    v = lin("value_proj", value)
    if key_padding_mask is not None:
        v = v.masked_fill(key_padding_mask[..., None], 0.0)
    v = v.reshape(b, value.shape[1], n_heads, e // n_heads)
    off = lin("sampling_offsets", query).reshape(
        b, q, n_heads, n_levels, n_points, 2)
    aw = torch.softmax(lin("attention_weights", query).reshape(
        b, q, n_heads, n_levels * n_points), -1)
    aw = aw.reshape(b, q, n_heads, n_levels, n_points)
    loc = sampling_locations(reference_points, off, spatial_shapes,
                             n_points)
    return lin("output_proj",
               ms_deform_attn_core(v, spatial_shapes, loc, aw))


class MSDeformAttn(nn.Module):
    """The MSDeformAttn module with torch-Linear checkpoint weights
    (sampling_offsets, attention_weights, value_proj, output_proj;
    ref:ms_deform_attn.py:232-345), as GroundingDINO holds it."""

    def __init__(self, embed_dim: int, heads: int, levels: int,
                 n_points: int, device="cuda"):
        super().__init__()
        self.heads, self.levels, self.n_points = heads, levels, n_points
        n = heads * levels * n_points
        self.sampling_offsets = linear(embed_dim, 2 * n, device=device)
        self.attention_weights = linear(embed_dim, n, device=device)
        self.value_proj = linear(embed_dim, embed_dim, device=device)
        self.output_proj = linear(embed_dim, embed_dim, device=device)

    def forward(self, query: torch.Tensor, value: torch.Tensor,
                ref_points: torch.Tensor,
                shapes: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """query (B, Q, E); value (B, S, E); ref_points (B, Q, L, 2 or 4)
        normalized."""
        b, q, e = query.shape
        h, lv, p = self.heads, self.levels, self.n_points
        v = self.value_proj(value).reshape(b, -1, h, e // h)
        off = self.sampling_offsets(query).reshape(b, q, h, lv, p, 2)
        aw = torch.softmax(self.attention_weights(query)
                           .reshape(b, q, h, lv * p), -1)
        loc = sampling_locations(ref_points, off, shapes, p)
        return self.output_proj(ms_deform_attn_core(
            v, shapes, loc, aw.reshape(b, q, h, lv, p)))
