"""Fused forward blend + 2D->3D feature lift on the GPU.

Counterpart of goi_tpu/raster/pallas_blend.py `_trace_kernel` and
`trace_tiles_pallas`. The kernel is csrc/trace.cu on a CUDA tensor, its
plain PyTorch version `trace_fwd_plain` on a CPU tensor. One walk gives
the forward blend's raw tile output (raster/cuda_blend.py's layout) and,
per sorted instance, the sum over its tile's pixels that blend it with
alpha > 0.005 of the pixel's augmented feature [img (S_img), 1]; the
caller zeroes that vector outside the image, so the ones channel counts
hits inside the frame only. raster/render.py `trace` sums the rows per
Gaussian with raster/reduce.py.

Widths: the render's semantic width as raster/cuda_blend.py (padded up
to a kernel instance; above S_MAX the trace kernel runs the lift with
semantic channel group 0 and cuda_blend's forward the later groups, so
the raw output stays the forward's bit for bit); the lift takes
sa = S_img + 1 up to SA_MAX fields on a CUDA tensor, and any sa in the
plain version.
"""

from __future__ import annotations

import ctypes

import torch

from goi_tpu_torch.raster import _nvcc
from goi_tpu_torch.raster.blend import _tile_pixel_coords, pair_alpha
from goi_tpu_torch.raster.cuda_blend import (K, PIX, PLAIN_TILE_BATCH,
                                             S_MAX, _blend_fwd_launch,
                                             _check_kernel_inputs,
                                             _fwd_in_groups, _group_rows,
                                             kernel_width, lane_features,
                                             pad_feat, unpad_raw)
from goi_tpu_torch.raster.reference import T_EPS

HIT_ALPHA = 0.005     # strict: a blended instance lifts iff alpha > this
SA_MAX = 127          # lifted fields per row (S_img + 1) on the card: 126
                      # channels, as the JAX package's pallas trace

_SIGNATURES = {"goi_trace_fwd": [
    ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]}


def _check_lift_width(aug: torch.Tensor, num_tiles: int) -> int:
    if aug.dim() != 3 or aug.shape[:2] != (num_tiles, PIX) \
            or aug.shape[-1] < 1:
        raise ValueError(f"aug of shape ({num_tiles}, {PIX}, S_img + 1) "
                         f"expected, got {tuple(aug.shape)}")
    return aug.shape[-1]


def trace_fwd_plain(feat, starts, ends, aug, grid_x: int):
    """Plain version of the kernel: all tiles, K-chunks of their exact
    [start, end) ranges, with the transmittance multiplied one instance
    at a time in the kernel's order (a cumprod on the card associates
    differently, and the T < 1e-4 stop would then differ near the
    threshold); no cap on a tile's depth."""
    d, length = feat.shape
    n_out = d - 6
    num_tiles = starts.shape[0]
    grid_y = num_tiles // grid_x
    sa = _check_lift_width(aug, num_tiles)
    dev = feat.device
    xs, ys = _tile_pixel_coords(grid_x, grid_y, device=dev)
    lane = torch.arange(K, device=dev)
    out = torch.empty((num_tiles, PIX, n_out + 3), dtype=torch.float32,
                      device=dev)
    rows = torch.zeros((length, sa), dtype=torch.float32, device=dev)
    for t0 in range(0, num_tiles, PLAIN_TILE_BATCH):
        sl = slice(t0, min(t0 + PLAIN_TILE_BATCH, num_tiles))
        st, en = starts[sl].long(), ends[sl].long()
        g = st.shape[0]
        t = torch.ones((g, PIX), device=dev)
        stop = torch.zeros((g, PIX), dtype=torch.bool, device=dev)
        acc = torch.zeros((g, PIX, n_out), device=dev)
        walked = torch.zeros((g, PIX), device=dev)
        blended = torch.zeros((g, PIX), device=dev)
        t_before = torch.empty((g, PIX, K), device=dev)
        stop_after = torch.empty((g, PIX, K), dtype=torch.bool, device=dev)
        test = torch.empty((g, PIX), device=dev)
        n_chunks = (int((en - st).max()) + K - 1) // K
        for c in range(n_chunks):
            idx = st[:, None] + c * K + lane                  # (g, K)
            m = idx < en[:, None]
            f = lane_features(feat, idx, m)                   # (g, K, d)
            _, _, _, alpha, valid = pair_alpha(f[..., 0:2], f[..., 2:5],
                                               f[..., 5], m, xs[sl], ys[sl])
            q = torch.where(valid, 1.0 - alpha, torch.ones_like(alpha))
            stop_in = stop.clone()
            for j in range(K):
                t_before[..., j] = t
                torch.mul(t, q[..., j], out=test)
                stop |= test < T_EPS
                stop_after[..., j] = stop
                t = torch.where(stop, t, test)
            stop_before = torch.cat([stop_in[..., None],
                                     stop_after[..., :-1]], dim=-1)
            walked += (m[:, None, :] & ~stop_before).sum(-1)
            active = valid & ~stop_after
            blended += active.sum(-1)
            w = torch.where(active, alpha * t_before, torch.zeros_like(alpha))
            acc += torch.bmm(w, f[..., 6:])
            hit = (active & (alpha > HIT_ALPHA)).to(torch.float32)
            lifted = torch.bmm(hit.transpose(1, 2), aug[sl])  # (g, K, sa)
            rows[idx[m]] = lifted[m]
            if bool(stop.all()):
                break
        out[sl, :, :n_out] = acc
        out[sl, :, n_out] = t
        out[sl, :, n_out + 1] = walked
        out[sl, :, n_out + 2] = blended
    return out, rows


def trace_fwd(feat: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor,
              aug: torch.Tensor, grid_x: int):
    """feat (10 + S, M) float32 packed instances, starts/ends (T,) int32
    tile ranges, aug (T, 256, S_img + 1) float32 per-pixel features with
    the ones channel -> (raw (T, 256, 4 + S + 3) as cuda_blend.blend_fwd's,
    rows (M, S_img + 1) by sorted position). The tile ranges tile
    [0, ends[-1]) in order, as the binning gives them."""
    num_tiles = starts.shape[0]
    sa = _check_lift_width(aug, num_tiles)
    if not _nvcc.is_cuda(feat):
        return trace_fwd_plain(feat, starts, ends, aug, grid_x)
    s_dim = _check_kernel_inputs(feat, starts, ends, aug)
    if sa > SA_MAX:
        raise ValueError(
            f"the trace kernel lifts 0..{SA_MAX - 1} feature channels "
            f"(S_img + 1 <= SA_MAX = {SA_MAX}), got S_img = {sa - 1}; use "
            f"RasterConfig(backend=\"reference\") for wider maps")
    starts = starts.contiguous()
    ends = ends.contiguous()
    aug = aug.contiguous()
    if s_dim <= S_MAX:
        return _trace_launch(feat, starts, ends, aug, grid_x)
    raw0, rows = _trace_launch(_group_rows(feat, s_dim, 0, S_MAX), starts,
                               ends, aug, grid_x)
    raw = _fwd_in_groups(
        feat, S_MAX, lambda f: _blend_fwd_launch(f, starts, ends, grid_x),
        raw0=raw0)
    return raw, rows


def _trace_launch(feat, starts, ends, aug, grid_x: int):
    """One launch of the instance that holds feat's width (S <= S_MAX)."""
    s_dim = feat.shape[0] - 10
    width = kernel_width(s_dim)
    num_tiles = starts.shape[0]
    sa = aug.shape[-1]
    lib = _nvcc.library("trace", _SIGNATURES)
    feat = pad_feat(feat, width).contiguous()
    out = torch.empty((num_tiles, PIX, width + 7), dtype=torch.float32,
                      device=feat.device)
    # the kernel writes every row, zeros where no pixel hits
    rows = torch.empty((feat.shape[1], sa), dtype=torch.float32,
                       device=feat.device)
    _nvcc.check(lib.goi_trace_fwd(
        width, feat.data_ptr(), feat.shape[1], starts.data_ptr(),
        ends.data_ptr(), num_tiles, grid_x, aug.data_ptr(), sa,
        out.data_ptr(), rows.data_ptr(), _nvcc.stream()), "trace_fwd")
    trace_fwd.launches += 1
    return unpad_raw(out, s_dim, width), rows


trace_fwd.launches = 0
