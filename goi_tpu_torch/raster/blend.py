"""Tiled alpha-blend helpers: tile <-> image layout and the per-chunk
blend math.

Counterpart of goi_tpu/raster/blend.py. One 16x16 tile is one unit of
work (ref:cuda_rasterizer/config.h:16-17). `chunk_weights` is the math
of one chunk of a tile's depth-ordered instances, vectorized over
(tiles, pixels, chunk); the plain versions of the forward- and
backward-blend kernels (raster/cuda_blend.py) compose it chunk by
chunk. The trace kernel's plain version (raster/cuda_trace.py) takes
only its per-pair alpha (`pair_alpha`) and multiplies the
transmittance itself, in the kernel's order. The XLA-backend
`blend_tiles` (with its `tile_cap` truncation) is not ported: the
port's blend walks each tile's exact range.
"""

from __future__ import annotations

import torch

from goi_tpu_torch.raster.preprocess import TILE
from goi_tpu_torch.raster.reference import ALPHA_CLAMP, ALPHA_MIN, T_EPS


def _tile_pixel_coords(grid_x: int, grid_y: int, device=None):
    """(T, 256) float pixel coordinates (x, y) of every tile's pixels."""
    t = torch.arange(grid_x * grid_y, device=device)
    ox = (t % grid_x) * TILE
    oy = (t // grid_x) * TILE
    p = torch.arange(TILE * TILE, device=device)
    xs = ox[:, None] + (p % TILE)[None, :]
    ys = oy[:, None] + (p // TILE)[None, :]
    return xs.to(torch.float32), ys.to(torch.float32)


def pair_alpha(mean2d, conic, opacity, m, xs, ys):
    """Per pixel x instance alpha of one chunk (shapes as chunk_weights):
    dx, dy (mean minus pixel), raw = opacity exp(power) (unclamped), the
    clamped alpha and valid (in range, power <= 0, alpha >= 1/255), each
    (T, P, k)."""
    dx = mean2d[:, None, :, 0] - xs[:, :, None]        # (T, P, k)
    dy = mean2d[:, None, :, 1] - ys[:, :, None]
    ca = conic[:, None, :, 0]
    cb = conic[:, None, :, 1]
    cc = conic[:, None, :, 2]
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    raw = opacity[:, None, :] * torch.exp(power)
    alpha = torch.clamp(raw, max=ALPHA_CLAMP)
    valid = m[:, None, :] & (power <= 0.0) & (alpha >= ALPHA_MIN)
    return dx, dy, raw, alpha, valid


def chunk_weights(mean2d, conic, opacity, m, xs, ys, t_all):
    """Blend math of one chunk (ref:cuda_rasterizer/forward.cu:331-371).

    mean2d (T, k, 2), conic (T, k, 3), opacity (T, k): the chunk's
    instances per tile, in blend order; m (T, k): which lie in the
    tile's [start, end); xs/ys (T, P) pixel coordinates; t_all (T, P)
    the transmittance carried in (the product of q over every valid
    instance so far; it drives the sticky T < 1e-4 stop).

    The transmittance is one sequential product with the carry in front,
    T_i = T_{i-1} (1 - alpha_i), the order in which the CUDA kernel
    multiplies. Returns a dict of (T, P, k) tensors: dx, dy (mean minus
    pixel), raw = opacity exp(power) (unclamped), alpha, valid, q,
    p_incl (T after the instance), p_excl (T before it), active (valid
    and not stopped) and w = alpha T_before on active instances."""
    dx, dy, raw, alpha, valid = pair_alpha(mean2d, conic, opacity, m, xs,
                                           ys)
    q = torch.where(valid, 1.0 - alpha, torch.ones_like(alpha))
    p_all = torch.cumprod(torch.cat([t_all[:, :, None], q], dim=-1), dim=-1)
    p_incl = p_all[..., 1:]
    p_excl = p_all[..., :-1]
    active = valid & (p_incl >= T_EPS)
    w = torch.where(active, alpha * p_excl, torch.zeros_like(alpha))
    return dict(dx=dx, dy=dy, raw=raw, alpha=alpha, valid=valid, q=q,
                p_incl=p_incl, p_excl=p_excl, active=active, w=w)


def tiles_to_image(tiles: torch.Tensor, grid_x: int, grid_y: int,
                   height: int, width: int) -> torch.Tensor:
    """(T, 256, C) tile-major -> (C, H, W) image, cropping tile padding."""
    c = tiles.shape[-1]
    img = tiles.reshape(grid_y, grid_x, TILE, TILE, c)
    img = img.permute(4, 0, 2, 1, 3).reshape(c, grid_y * TILE,
                                            grid_x * TILE)
    return img[:, :height, :width]
