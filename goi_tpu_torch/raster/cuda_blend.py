"""Forward tiled blend on the GPU: pack, kernel, background composite.

Counterpart of goi_tpu/raster/pallas_blend.py (forward half). The pack
gathers each instance's features into one feature-major matrix; the
blend is the hand-written CUDA kernel csrc/blend_fwd.cu on a CUDA tensor
and its plain PyTorch version (`blend_fwd_plain`) on a CPU tensor.

Feature rows of the packed matrix (D = 10 + S):
  0:x 1:y 2:conic_a 3:conic_b 4:conic_c 5:opacity 6..8:rgb
  9..9+S-1:semantics 9+S:depth
Raw output per pixel (OUTC = 4 + S + 3):
  0..2 color sums, 3..3+S-1 semantic sums, 3+S depth sum, 4+S T of the
  blended instances, then the counts of instances walked and blended.

The TPU layout's 8-row padding, +K tail columns and transported
Gaussian-id row were Mosaic DMA workarounds or backward-only inputs and
are not packed here; the backward, once ported, adds what it needs.
"""

from __future__ import annotations

import ctypes

import torch

from goi_tpu_torch.raster import _nvcc
from goi_tpu_torch.raster.binning import Binning
from goi_tpu_torch.raster.blend import _tile_pixel_coords, chunk_weights
from goi_tpu_torch.raster.preprocess import TILE, Splats
from goi_tpu_torch.raster.reference import T_EPS

K = 256            # instances per chunk: the chunked layout's walk unit
PIX = TILE * TILE
SEM_DIMS = (0, 3, 8, 10, 16)   # template instances in csrc/blend_fwd.cu
# tiles per step of the plain version: bounds its (tiles, 256, K)
# temporaries to a few hundred MB
PLAIN_TILE_BATCH = 128

_SIGNATURES = {"goi_blend_fwd": [
    ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_void_p]}


def _pack_impl(mean2d, conic, opacity, color, semantics, depth, gid):
    """Per-instance features, feature-major (10 + S, M): one gather of a
    per-Gaussian feature matrix by the tile-sorted Gaussian ids."""
    per_gauss = torch.cat([mean2d.T, conic.T, opacity[None], color.T,
                           semantics.T, depth[None]], dim=0)
    return per_gauss[:, gid.long()].contiguous()


def blend_fwd_plain(feat, starts, ends, grid_x: int):
    """Plain version of the kernel: all tiles, K-chunks of their exact
    [start, end) ranges, composed with blend.chunk_weights; no cap on a
    tile's depth."""
    d, length = feat.shape
    n_out = d - 6
    num_tiles = starts.shape[0]
    grid_y = num_tiles // grid_x
    dev = feat.device
    xs, ys = _tile_pixel_coords(grid_x, grid_y, device=dev)
    lane = torch.arange(K, device=dev)
    out = torch.empty((num_tiles, PIX, n_out + 3), dtype=torch.float32,
                      device=dev)
    for t0 in range(0, num_tiles, PLAIN_TILE_BATCH):
        sl = slice(t0, min(t0 + PLAIN_TILE_BATCH, num_tiles))
        st, en = starts[sl].long(), ends[sl].long()
        g = st.shape[0]
        t_all = torch.ones((g, PIX), device=dev)
        t_blend = torch.ones((g, PIX), device=dev)
        acc = torch.zeros((g, PIX, n_out), device=dev)
        walked = torch.zeros((g, PIX), device=dev)
        blended = torch.zeros((g, PIX), device=dev)
        n_chunks = (int((en - st).max()) + K - 1) // K
        for c in range(n_chunks):
            idx = st[:, None] + c * K + lane                  # (g, K)
            m = idx < en[:, None]
            f = feat[:, torch.clamp(idx, max=length - 1)]     # (d, g, K)
            f = f.permute(1, 2, 0)                            # (g, K, d)
            ck = chunk_weights(f[..., 0:2], f[..., 2:5], f[..., 5], m,
                               xs[sl], ys[sl], t_all)
            acc += torch.bmm(ck["w"], f[..., 6:])
            last = torch.where(ck["active"], ck["p_incl"],
                               torch.ones_like(ck["p_incl"]))
            t_blend = torch.minimum(t_blend, last.amin(-1))
            walked += (m[:, None, :] & (ck["p_excl"] >= T_EPS)).sum(-1)
            blended += ck["active"].sum(-1)
            t_all = ck["p_incl"][..., -1]
            if not bool((t_all >= T_EPS).any()):
                break
        out[sl, :, :n_out] = acc
        out[sl, :, n_out] = t_blend
        out[sl, :, n_out + 1] = walked
        out[sl, :, n_out + 2] = blended
    return out


def blend_fwd(feat: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor,
              grid_x: int) -> torch.Tensor:
    """feat (10 + S, M) float32 packed instances, starts/ends (T,) int32
    tile ranges -> raw (T, 256, 4 + S + 3) (see the module docstring)."""
    if not _nvcc.is_cuda(feat):
        return blend_fwd_plain(feat, starts, ends, grid_x)
    s_dim = feat.shape[0] - 10
    if s_dim not in SEM_DIMS:
        raise ValueError(f"the CUDA blend is built for sem_dim in "
                         f"{SEM_DIMS}, got {s_dim}")
    if feat.dtype != torch.float32 or starts.dtype != torch.int32 \
            or ends.dtype != torch.int32:
        raise TypeError("float32 feat and int32 starts/ends expected")
    if not (_nvcc.is_cuda(starts) and _nvcc.is_cuda(ends)):
        raise ValueError("feat, starts and ends must be on the CUDA device")
    lib = _nvcc.library("blend_fwd", _SIGNATURES)
    feat = feat.contiguous()
    starts = starts.contiguous()
    ends = ends.contiguous()
    num_tiles = starts.shape[0]
    out = torch.empty((num_tiles, PIX, s_dim + 7), dtype=torch.float32,
                      device=feat.device)
    _nvcc.check(lib.goi_blend_fwd(
        s_dim, feat.data_ptr(), feat.shape[1], starts.data_ptr(),
        ends.data_ptr(), num_tiles, grid_x, out.data_ptr(),
        _nvcc.stream()), "blend_fwd")
    blend_fwd.launches += 1
    return out


blend_fwd.launches = 0


class _BlendCore(torch.autograd.Function):
    """pack + tiled blend under one autograd node (the role of
    pallas_blend._blend_core's custom VJP)."""

    @staticmethod
    def forward(ctx, mean2d, conic, opacity, color, semantics, depth, gid,
                starts, ends, grid_x):
        feat = _pack_impl(mean2d, conic, opacity, color, semantics, depth,
                          gid)
        return blend_fwd(feat, starts, ends, grid_x)

    @staticmethod
    def backward(ctx, grad_raw):
        raise NotImplementedError(
            "the tiled blend's backward kernel is not ported yet")


def blend_tiles_cuda(sp: Splats, binning: Binning, bg: torch.Tensor, *,
                     grid_x: int):
    """Per-tile images: color (T,256,3), semantics (T,256,S),
    depth (T,256), alpha (T,256)."""
    s = sp.semantics.shape[-1]
    n_out = 3 + s + 1
    raw = _BlendCore.apply(sp.mean2d, sp.conic, sp.opacity, sp.color,
                           sp.semantics, sp.depth, binning.point_list,
                           binning.tile_start, binning.tile_end, grid_x)
    t_final = raw[:, :, n_out]
    color = raw[:, :, :3] + t_final[:, :, None] * bg[None, None, :]
    sem = raw[:, :, 3:3 + s]
    depth = raw[:, :, 3 + s]
    return color, sem, depth, 1.0 - t_final
