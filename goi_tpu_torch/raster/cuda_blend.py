"""Tiled blend on the GPU: pack, forward and backward kernels, background
composite.

Counterpart of goi_tpu/raster/pallas_blend.py (`_pack_impl`,
`_blend_core` with its custom VJP, `blend_tiles_pallas`). The pack
gathers each instance's features into one feature-major matrix; the
forward blend is the hand-written CUDA kernel csrc/blend_fwd.cu and the
backward csrc/blend_bwd.cu on a CUDA tensor, their plain PyTorch
versions (`blend_fwd_plain`, `blend_bwd_plain`) on a CPU tensor. The
backward's per-instance rows reduce to per-Gaussian gradients in
raster/reduce.py.

Feature rows of the packed matrix (D = 10 + S):
  0:x 1:y 2:conic_a 3:conic_b 4:conic_c 5:opacity 6..8:rgb
  9..9+S-1:semantics 9+S:depth
Raw output per pixel (OUTC = 4 + S + 3):
  0..2 color sums, 3..3+S-1 semantic sums, 3+S depth sum, 4+S T of the
  blended instances, then the counts of instances walked and blended.
Backward rows (M, 10 + S), one per sorted instance position, in the
feature layout: the gradients of x, y, conic a, b, c, opacity, rgb,
semantics and depth.

The TPU layout's 8-row padding, +K tail columns and transported
Gaussian-id row were Mosaic DMA workarounds and are not packed here.
"""

from __future__ import annotations

import ctypes

import torch

from goi_tpu_torch.raster import _nvcc
from goi_tpu_torch.raster.binning import Binning
from goi_tpu_torch.raster.blend import _tile_pixel_coords, chunk_weights
from goi_tpu_torch.raster.preprocess import TILE, Splats
from goi_tpu_torch.raster.reduce import reduce_chain, reduce_scatter
from goi_tpu_torch.raster.reference import ALPHA_CLAMP, T_EPS

K = 256            # instances per chunk: the chunked layout's walk unit
PIX = TILE * TILE
SEM_DIMS = (0, 3, 8, 10, 16)   # template instances in csrc/blend_*.cu
# tiles per step of the plain version: bounds its (tiles, 256, K)
# temporaries to a few hundred MB
PLAIN_TILE_BATCH = 128

_SIGNATURES = {"goi_blend_fwd": [
    ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_void_p]}
_BWD_SIGNATURES = {"goi_blend_bwd": [
    ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]}


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


def _check_kernel_inputs(feat, starts, ends, *more) -> int:
    """The checks both blend wrappers make before a launch; returns S."""
    s_dim = feat.shape[0] - 10
    if s_dim not in SEM_DIMS:
        raise ValueError(f"the CUDA blend is built for sem_dim in "
                         f"{SEM_DIMS}, got {s_dim}")
    if feat.dtype != torch.float32 or starts.dtype != torch.int32 \
            or ends.dtype != torch.int32 \
            or any(t.dtype != torch.float32 for t in more):
        raise TypeError("float32 feat, raw and grad and int32 starts/ends "
                        "expected")
    if not all(_nvcc.is_cuda(t) and t.device == feat.device
               for t in (starts, ends) + more):
        raise ValueError("all blend inputs must be on one CUDA device")
    return s_dim


def blend_fwd(feat: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor,
              grid_x: int) -> torch.Tensor:
    """feat (10 + S, M) float32 packed instances, starts/ends (T,) int32
    tile ranges -> raw (T, 256, 4 + S + 3) (see the module docstring)."""
    if not _nvcc.is_cuda(feat):
        return blend_fwd_plain(feat, starts, ends, grid_x)
    s_dim = _check_kernel_inputs(feat, starts, ends)
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


def blend_bwd_plain(feat, starts, ends, raw, grad, grid_x: int):
    """Plain version of the backward kernel: the forward's chunk walk
    (blend.chunk_weights) with the suffix-from-total identity, summed
    over each tile's pixels; rows of instances past a pixel's stop, and
    of positions no tile holds, stay zero."""
    d, length = feat.shape
    n_out = d - 6
    num_tiles = starts.shape[0]
    grid_y = num_tiles // grid_x
    dev = feat.device
    xs, ys = _tile_pixel_coords(grid_x, grid_y, device=dev)
    lane = torch.arange(K, device=dev)
    rows = torch.zeros((length, d), dtype=torch.float32, device=dev)
    for t0 in range(0, num_tiles, PLAIN_TILE_BATCH):
        sl = slice(t0, min(t0 + PLAIN_TILE_BATCH, num_tiles))
        st, en = starts[sl].long(), ends[sl].long()
        g = st.shape[0]
        gc = grad[sl, :, :n_out]                          # (g, P, n_out)
        total = (gc * raw[sl, :, :n_out]).sum(-1) \
            + grad[sl, :, n_out] * raw[sl, :, n_out]       # (g, P)
        t_all = torch.ones((g, PIX), device=dev)
        prefix = torch.zeros((g, PIX), device=dev)
        n_chunks = (int((en - st).max()) + K - 1) // K
        for c in range(n_chunks):
            idx = st[:, None] + c * K + lane                  # (g, K)
            m = idx < en[:, None]
            f = feat[:, torch.clamp(idx, max=length - 1)]     # (d, g, K)
            f = f.permute(1, 2, 0)                            # (g, K, d)
            ck = chunk_weights(f[..., 0:2], f[..., 2:5], f[..., 5], m,
                               xs[sl], ys[sl], t_all)
            w, dx, dy = ck["w"], ck["dx"], ck["dy"]           # (g, P, K)
            fdotg = torch.bmm(gc, f[..., 6:].transpose(1, 2))
            prefix_incl = prefix[..., None] + torch.cumsum(w * fdotg, -1)
            dalpha = torch.where(
                ck["active"], ck["p_excl"] * fdotg
                - (total[..., None] - prefix_incl) / ck["q"],
                torch.zeros_like(w))
            dpow = torch.where(ck["raw"] < ALPHA_CLAMP, ck["raw"] * dalpha,
                               torch.zeros_like(w))
            ca, cb, cc = (f[:, None, :, 2], f[:, None, :, 3],
                          f[:, None, :, 4])
            opa = f[..., 5]
            m0 = dpow.sum(1)                                  # (g, K)
            geo = torch.stack([
                (dpow * -(ca * dx + cb * dy)).sum(1),
                (dpow * -(cc * dy + cb * dx)).sum(1),
                (-0.5 * dpow * dx * dx).sum(1),
                (-dpow * dx * dy).sum(1),
                (-0.5 * dpow * dy * dy).sum(1),
                torch.where(opa > 0.0, m0 / torch.where(
                    opa > 0.0, opa, torch.ones_like(opa)),
                    torch.zeros_like(m0)),
            ], dim=-1)                                        # (g, K, 6)
            dfo = torch.bmm(w.transpose(1, 2), gc)            # (g, K, n_out)
            rows[idx[m]] = torch.cat([geo, dfo], dim=-1)[m]
            prefix = prefix_incl[..., -1]
            t_all = ck["p_incl"][..., -1]
            if not bool((t_all >= T_EPS).any()):
                break
    return rows


def blend_bwd(feat: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor,
              raw: torch.Tensor, grad: torch.Tensor,
              grid_x: int) -> torch.Tensor:
    """feat (10 + S, M), starts/ends (T,) as for blend_fwd, raw the
    forward's output and grad its gradient, both (T, 256, 4 + S + 3) ->
    per-instance gradient rows (M, 10 + S) by sorted position."""
    if not _nvcc.is_cuda(feat):
        return blend_bwd_plain(feat, starts, ends, raw, grad, grid_x)
    s_dim = _check_kernel_inputs(feat, starts, ends, raw, grad)
    num_tiles = starts.shape[0]
    if raw.shape != (num_tiles, PIX, s_dim + 7) or raw.shape != grad.shape:
        raise ValueError(f"raw and grad of shape {(num_tiles, PIX, s_dim + 7)}"
                         f" expected, got {tuple(raw.shape)} and "
                         f"{tuple(grad.shape)}")
    lib = _nvcc.library("blend_bwd", _BWD_SIGNATURES)
    feat = feat.contiguous()
    starts = starts.contiguous()
    ends = ends.contiguous()
    raw = raw.contiguous()
    grad = grad.contiguous()
    rows = torch.zeros((feat.shape[1], feat.shape[0]), dtype=torch.float32,
                       device=feat.device)
    _nvcc.check(lib.goi_blend_bwd(
        s_dim, feat.data_ptr(), feat.shape[1], starts.data_ptr(),
        ends.data_ptr(), num_tiles, grid_x, raw.data_ptr(), grad.data_ptr(),
        rows.data_ptr(), _nvcc.stream()), "blend_bwd")
    blend_bwd.launches += 1
    return rows


blend_bwd.launches = 0


def _chain_bounds(tiles_touched: torch.Tensor, m: int) -> torch.Tensor:
    """(N + 1,) expansion-stream boundaries of a budget of m slots, with
    the forced sentinel slots (counts' = max(counts, 1)), as the binning
    assigns slots: on overflow every Gaussian based at or past the last
    slot m - 1 is clamped there and the slot renders the last of them,
    so the bounds clamp to m - 1 and only the stream's end to m. (The
    JAX package's bounds give slot m - 1 to the Gaussian that straddles
    it instead, which disagrees with its scatter reduce.)"""
    counts = torch.clamp(tiles_touched.long(), min=1)
    ends = torch.cumsum(counts, 0)
    return torch.cat([torch.clamp(ends - counts, max=m - 1),
                      torch.clamp(ends[-1:], max=m)])


class _BlendCore(torch.autograd.Function):
    """pack + tiled blend under one autograd node (the role of
    pallas_blend._blend_core's custom VJP). The backward runs the
    backward kernel and then the reduce named by `reduce`: 'chain'
    (with the binning's `sort_slots` and the Gaussians' `tiles_touched`)
    or 'scatter' (by the sorted Gaussian ids); `dense` fuses the chain's
    prefix and boundary read-out (reduce.dense_boundary_reduce)."""

    @staticmethod
    def forward(ctx, mean2d, conic, opacity, color, semantics, depth, gid,
                starts, ends, grid_x, reduce, dense, sort_slots,
                tiles_touched):
        feat = _pack_impl(mean2d, conic, opacity, color, semantics, depth,
                          gid)
        raw = blend_fwd(feat, starts, ends, grid_x)
        ctx.grid_x, ctx.reduce, ctx.dense = grid_x, reduce, dense
        ctx.n_gauss, ctx.s_dim = mean2d.shape[0], semantics.shape[-1]
        ctx.save_for_backward(feat, starts, ends, raw, gid, sort_slots,
                              tiles_touched)
        return raw

    @staticmethod
    def backward(ctx, grad_raw):
        feat, starts, ends, raw, gid, sort_slots, tiles_touched = \
            ctx.saved_tensors
        rows = blend_bwd(feat, starts, ends, raw, grad_raw, ctx.grid_x)
        if ctx.reduce == "chain":
            acc = reduce_chain(rows, sort_slots,
                               _chain_bounds(tiles_touched, rows.shape[0]),
                               dense=ctx.dense)
        else:
            acc = reduce_scatter(rows, gid, ctx.n_gauss)
        s = ctx.s_dim
        return (acc[:, 0:2], acc[:, 2:5], acc[:, 5], acc[:, 6:9],
                acc[:, 9:9 + s], acc[:, 9 + s],
                None, None, None, None, None, None, None, None)


def blend_tiles_cuda(sp: Splats, binning: Binning, bg: torch.Tensor, *,
                     grid_x: int, reduce: str, dense: bool = False):
    """Per-tile images: color (T,256,3), semantics (T,256,S),
    depth (T,256), alpha (T,256). `reduce` ('scatter' | 'chain', already
    resolved) picks the backward's instance -> Gaussian reduction;
    'chain' needs a binning made with export_perm=True, and `dense`
    (chain only) fuses its prefix and boundary read-out."""
    if reduce not in ("scatter", "chain"):
        raise ValueError(f"unknown reduce {reduce!r} (resolve 'auto' "
                         f"before calling blend_tiles_cuda)")
    if dense and reduce != "chain":
        raise ValueError("dense needs reduce='chain'")
    if reduce == "chain" and binning.sort_slots is None:
        raise ValueError("reduce='chain' needs bin_splats_chunked("
                         "..., export_perm=True)")
    s = sp.semantics.shape[-1]
    raw = _BlendCore.apply(sp.mean2d, sp.conic, sp.opacity, sp.color,
                           sp.semantics, sp.depth, binning.point_list,
                           binning.tile_start, binning.tile_end, grid_x,
                           reduce, dense, binning.sort_slots,
                           sp.tiles_touched)
    return composite(raw, bg, s)


def composite(raw: torch.Tensor, bg: torch.Tensor, s: int):
    """Raw blend output (T, 256, 4 + S + 3) -> color with the background
    (T,256,3), semantics (T,256,S), depth (T,256), alpha (T,256)."""
    t_final = raw[:, :, 4 + s]
    color = raw[:, :, :3] + t_final[:, :, None] * bg[None, None, :]
    return color, raw[:, :, 3:3 + s], raw[:, :, 3 + s], 1.0 - t_final
