"""Oracle rasterizer: exact, slow, per-pixel blend over every Gaussian.

Counterpart of goi_tpu/raster/reference.py. It reproduces the sequential
semantics of renderCUDA (ref:cuda_rasterizer/forward.cu:261-386) in
closed form:

  for each pixel, over Gaussians sorted by (depth asc, index asc) and
  restricted to those whose tile-rect covers the pixel's tile:
    power = -0.5(A dx^2 + C dy^2) - B dx dy ; skip if power > 0
    alpha = min(0.99, opacity * exp(power)) ; skip if alpha < 1/255
    stop the pixel when T*(1-alpha) < 1e-4 (the stopping splat excluded)
    C += c * alpha * T ; S += s * alpha * T ; D += d * alpha * T
    T *= (1-alpha)
  out_color = C + T*bg ; out_semantic = S ; out_alpha = 1 - T

The sticky stop is a masked inclusive cumulative product: (1-alpha) <= 1
makes the unstopped product non-increasing, so "first index where
T*(1-a) < 1e-4, and everything after it" is {i : cumprod_incl_i < 1e-4}.
"""

from __future__ import annotations

import dataclasses

import torch

from goi_tpu_torch.core.camera import Camera
from goi_tpu_torch.core.scene import GaussianScene
from goi_tpu_torch.raster.preprocess import TILE, preprocess

ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4
ALPHA_CLAMP = 0.99


def blend_weights(alpha: torch.Tensor, contrib: torch.Tensor):
    """Per-step alphas (..., K) in traversal order and a contribution
    mask -> (weights (..., K), T_final (...,)) with the sequential
    semantics above."""
    valid = contrib & (alpha >= ALPHA_MIN)
    q = torch.where(valid, 1.0 - alpha, torch.ones_like(alpha))
    p_incl = torch.cumprod(q, dim=-1)
    active = valid & (p_incl >= T_EPS)
    t_prev = p_incl / q  # exclusive cumprod; q >= 1 - 0.99 > 0
    w = torch.where(active, alpha * t_prev, torch.zeros_like(alpha))
    t_final = torch.prod(torch.where(active, q, torch.ones_like(q)), dim=-1)
    return w, t_final


def render_reference(scene: GaussianScene, cam: Camera, bg_color, *,
                     scaling_modifier: float = 1.0, override_color=None,
                     semantic_masks=None, mean2d_offset=None,
                     row_chunk: int = 16):
    """dict(render (3,H,W), semantics (S,H,W), depth (1,H,W),
    alpha (1,H,W), radii (N,), visibility_filter (N,)), the reference
    render() contract (ref:gaussian_renderer/__init__.py:99-105)."""
    H, W = cam.height, cam.width
    dev = scene.xyz.device
    sp = preprocess(scene, cam, scaling_modifier=scaling_modifier,
                    override_color=override_color,
                    semantic_masks=semantic_masks)
    if mean2d_offset is not None:
        sp = dataclasses.replace(sp, mean2d=sp.mean2d + mean2d_offset)

    inf = torch.full_like(sp.depth, float("inf"))
    order = torch.argsort(torch.where(sp.valid, sp.depth, inf), stable=True)
    mean2d = sp.mean2d[order]
    conic = sp.conic[order]
    opac = sp.opacity[order]
    color = sp.color[order]
    sems = sp.semantics[order]
    depth = sp.depth[order]
    rmin = sp.rect_min[order]
    rmax = sp.rect_max[order]
    valid = sp.valid[order]

    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=dev)
    xs = torch.arange(W, dtype=torch.float32, device=dev)
    tile_x = torch.arange(W, device=dev) // TILE
    a, b, c = conic[:, 0], conic[:, 1], conic[:, 2]

    rows_c, rows_s, rows_d, rows_a = [], [], [], []
    for y0 in range(0, H, row_chunk):
        ys = torch.arange(y0, min(y0 + row_chunk, H), device=dev)
        yf = ys.to(torch.float32)[:, None, None]
        ty = (ys // TILE)[:, None, None]
        dx = mean2d[None, None, :, 0] - xs[None, :, None]   # (R, W, N)
        dy = mean2d[None, None, :, 1] - yf
        power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
        alpha = torch.clamp(opac * torch.exp(power), max=ALPHA_CLAMP)
        in_rect = ((tile_x[None, :, None] >= rmin[:, 0])
                   & (tile_x[None, :, None] < rmax[:, 0])
                   & (ty >= rmin[:, 1]) & (ty < rmax[:, 1]))
        contrib = valid & in_rect & (power <= 0.0)
        w, t_final = blend_weights(alpha, contrib)
        rows_c.append(w @ color + t_final[..., None] * bg)
        rows_s.append(w @ sems)
        rows_d.append(w @ depth)
        rows_a.append(1.0 - t_final)
    out_c = torch.cat(rows_c)          # (H, W, 3)
    out_s = torch.cat(rows_s)
    return {
        "render": out_c.permute(2, 0, 1),
        "semantics": out_s.permute(2, 0, 1),
        "depth": torch.cat(rows_d)[None],
        "alpha": torch.cat(rows_a)[None],
        "radii": sp.radius,
        "visibility_filter": sp.radius > 0,
    }
