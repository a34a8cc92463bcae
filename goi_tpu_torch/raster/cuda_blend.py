"""Tiled blend on the GPU: pack, forward and backward kernels, background
composite.

Counterpart of goi_tpu/raster/pallas_blend.py (`_pack_impl`,
`_blend_core` with its custom VJP, `blend_tiles_pallas`). The pack
gathers each instance's features into one feature-major matrix; the
forward blend is the hand-written CUDA kernel csrc/blend_fwd.cu and the
backward csrc/blend_bwd.cu on a CUDA tensor, their plain PyTorch
versions (`blend_fwd_plain`, `blend_bwd_plain`) on a CPU tensor. The
backward's per-instance rows reduce to per-Gaussian gradients in
raster/reduce.py (`reduce_rows` picks the reduce).

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

Semantic widths: the kernels are built for S in SEM_DIMS. Any other S up
to S_MAX runs the next wider instance on a copy padded with zero
semantic rows (`pad_feat`, `pad_raw`), whose outputs are sliced back
(`unpad_raw`, `unpad_rows`): the padded channels are zero and add
nothing, so the real channels and the counts are the bits an instance of
S's own width would give. Above S_MAX the channels run in groups of at
most S_MAX, one launch a group (`_fwd_in_groups`, `_bwd_in_groups`): the
walk, the alphas, the transmittance and the stop depend only on geometry
and opacity, so each semantic channel of the forward has the bits of a
lone run of its group, and the backward's geometry rows are the sum of
the groups' (in another order than one wide launch would sum them). The
plain versions take any width in one call.
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
from goi_tpu_torch.utils.profiling import armed, count, span

K = 256            # instances per chunk: the walk unit
PIX = TILE * TILE
SEM_DIMS = (0, 3, 8, 10, 16, 32, 64)   # template instances in
                                       # csrc/blend_*.cu and trace.cu
S_MAX = SEM_DIMS[-1]   # the widest instance (blend_bwd.cu's tile needs
                       # 175 KB of shared memory at S = 64); wider S runs
                       # in channel groups of S_MAX
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


def pack(mean2d, conic, opacity, color, semantics, depth, gid):
    """Per-instance features, feature-major (10 + S, M): one gather of a
    per-Gaussian feature matrix by the tile-sorted Gaussian ids."""
    per_gauss = torch.cat([mean2d.T, conic.T, opacity[None], color.T,
                           semantics.T, depth[None]], dim=0)
    return per_gauss[:, gid.long()].contiguous()


def lane_features(feat, idx, m):
    """(g, K, d) packed rows of a chunk's lanes idx (g, K) for the plain
    walks, zero where m is false: those lanes read the stream past the
    tile's range, where a culled Gaussian's non-finite values (a NaN
    position) would reach the sums through a zero weight."""
    f = feat[:, torch.clamp(idx, max=feat.shape[1] - 1)].permute(1, 2, 0)
    return torch.where(m[..., None], f, torch.zeros_like(f))


def blend_fwd_plain(feat, starts, ends, grid_x: int):
    """Plain version of the kernel: all tiles, K-chunks of their exact
    [start, end) ranges, composed with blend.chunk_weights; no cap on a
    tile's depth."""
    n_out = feat.shape[0] - 6
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
            f = lane_features(feat, idx, m)                   # (g, K, d)
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


def kernel_width(s_dim: int) -> int:
    """The kernel instance that runs semantic width s_dim: the narrowest
    in SEM_DIMS that holds it. Above S_MAX the channels run in groups of
    S_MAX (`_channel_groups`): every full group on the S_MAX instance
    named here, a narrower last group on the instance of its own width."""
    if s_dim < 0:
        raise ValueError(f"sem_dim must be >= 0, got {s_dim}")
    return next((w for w in SEM_DIMS if w >= s_dim), S_MAX)


def _channel_groups(s_dim: int, group: int) -> list:
    """[lo, hi) ranges of at most `group` semantic channels that cover
    0..s_dim - 1 in order (one empty range at S = 0)."""
    return [(lo, min(lo + group, s_dim))
            for lo in range(0, max(s_dim, 1), group)]


def _group_rows(feat: torch.Tensor, s_dim: int, lo: int,
                hi: int) -> torch.Tensor:
    """(10 + S, M) packed features -> those of semantic channels lo..hi-1:
    geometry, opacity and rgb (rows 0..8), semantic rows 9 + lo ..
    9 + hi - 1, depth."""
    if (lo, hi) == (0, s_dim):
        return feat
    return torch.cat([feat[:9], feat[9 + lo:9 + hi], feat[9 + s_dim:]])


def _group_cols(raw: torch.Tensor, s_dim: int, lo: int,
                hi: int) -> torch.Tensor:
    """(T, 256, S + 7) raw output or its gradient -> the columns of
    semantic channels lo..hi-1 in the same layout (rgb, those channels,
    depth, T, counts)."""
    if (lo, hi) == (0, s_dim):
        return raw
    return torch.cat([raw[..., :3], raw[..., 3 + lo:3 + hi],
                      raw[..., 3 + s_dim:]], dim=-1)


def _fwd_in_groups(feat: torch.Tensor, group: int, run,
                   raw0: torch.Tensor = None) -> torch.Tensor:
    """The raw forward output of S semantic channels as passes over
    channel groups of at most `group`; `run` maps a group's packed
    features to its raw output. Group 0 gives rgb, depth, T and the
    counts (`raw0`, when given, is its raw output already computed);
    each later group only its semantic columns, the bits of a lone run of
    that group: a channel's sum depends on the walk and its own row."""
    s_dim = feat.shape[0] - 10
    (_, hi0), *later = _channel_groups(s_dim, group)
    if raw0 is None:
        raw0 = run(_group_rows(feat, s_dim, 0, hi0))
    sems = [run(_group_rows(feat, s_dim, lo, hi))[..., 3:3 + hi - lo]
            for lo, hi in later]
    return torch.cat([raw0[..., :3 + hi0], *sems, raw0[..., 3 + hi0:]],
                     dim=-1)


def _bwd_in_groups(feat: torch.Tensor, raw: torch.Tensor,
                   grad: torch.Tensor, group: int, run) -> torch.Tensor:
    """The backward rows (M, 10 + S) as passes over channel groups of at
    most `group`; `run(feat_g, raw_g, grad_g)` gives a group's rows.

    Every per-pixel term of the backward (blend_bwd.cu's header) is
    linear in the output gradient: total = sum_c g_c out_c + g_T T,
    f . g, the prefix, dalpha and dpow; the walk depends on neither. So
    each group runs with the forward's raw columns as they are; group 0
    with the gradient of rgb, its channels, depth and T, every later
    group with the gradient of its channels only (rgb, depth, T and the
    counts zeroed: a zero gradient adds exact zeros, and the background
    term through T is counted once). The semantic rows are each group's,
    rgb and depth group 0's, and the geometry rows (x, y, conic a/b/c,
    opacity) the sum of the groups', in group order."""
    s_dim = feat.shape[0] - 10
    geo = rgb = depth = None
    sems = []
    for lo, hi in _channel_groups(s_dim, group):
        w = hi - lo
        g = _group_cols(grad, s_dim, lo, hi)
        if lo:
            g = torch.cat([torch.zeros_like(g[..., :3]), g[..., 3:3 + w],
                           torch.zeros_like(g[..., 3 + w:])], dim=-1)
        rows = run(_group_rows(feat, s_dim, lo, hi),
                   _group_cols(raw, s_dim, lo, hi), g)
        if lo:
            geo = geo + rows[:, :6]
        else:
            geo, rgb, depth = rows[:, :6], rows[:, 6:9], rows[:, 9 + w:]
        sems.append(rows[:, 9:9 + w])
    return torch.cat([geo, rgb, *sems, depth], dim=1)


def pad_feat(feat: torch.Tensor, width: int) -> torch.Tensor:
    """(10 + S, M) packed features -> (10 + width, M) with zero semantic
    rows 9 + S .. 9 + width - 1 (depth moves to row 9 + width)."""
    s = feat.shape[0] - 10
    if width == s:
        return feat
    return torch.cat([feat[:9 + s],
                      feat.new_zeros((width - s, feat.shape[1])),
                      feat[9 + s:]])


def pad_raw(raw: torch.Tensor, s_dim: int, width: int) -> torch.Tensor:
    """(T, 256, S + 7) raw output (or its gradient) -> (T, 256, width + 7)
    with zero semantic channels 3 + S .. 3 + width - 1."""
    if width == s_dim:
        return raw
    return torch.cat([raw[..., :3 + s_dim],
                      raw.new_zeros(raw.shape[:-1] + (width - s_dim,)),
                      raw[..., 3 + s_dim:]], dim=-1)


def unpad_raw(raw: torch.Tensor, s_dim: int, width: int) -> torch.Tensor:
    """pad_raw's inverse: drop semantic channels 3 + S .. 3 + width - 1."""
    if width == s_dim:
        return raw
    return torch.cat([raw[..., :3 + s_dim], raw[..., 3 + width:]], dim=-1)


def unpad_rows(rows: torch.Tensor, s_dim: int, width: int) -> torch.Tensor:
    """(M, 10 + width) backward rows -> (M, 10 + S): drop the padded
    semantic fields 9 + S .. 9 + width - 1."""
    if width == s_dim:
        return rows
    return torch.cat([rows[:, :9 + s_dim], rows[:, 9 + width:]], dim=1)


def _check_kernel_inputs(feat, starts, ends, *more) -> int:
    """The checks both blend wrappers make before a launch; returns S."""
    s_dim = feat.shape[0] - 10
    kernel_width(s_dim)
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
    starts = starts.contiguous()
    ends = ends.contiguous()

    def run(f):
        return _blend_fwd_launch(f, starts, ends, grid_x)

    if s_dim > S_MAX:
        return _fwd_in_groups(feat, S_MAX, run)
    return run(feat)


def _blend_fwd_launch(feat, starts, ends, grid_x: int) -> torch.Tensor:
    """One launch of the instance that holds feat's width (S <= S_MAX)."""
    s_dim = feat.shape[0] - 10
    width = kernel_width(s_dim)
    lib = _nvcc.library("blend_fwd", _SIGNATURES)
    feat = pad_feat(feat, width).contiguous()
    num_tiles = starts.shape[0]
    out = torch.empty((num_tiles, PIX, width + 7), dtype=torch.float32,
                      device=feat.device)
    _nvcc.check(lib.goi_blend_fwd(
        width, feat.data_ptr(), feat.shape[1], starts.data_ptr(),
        ends.data_ptr(), num_tiles, grid_x, out.data_ptr(),
        _nvcc.stream()), "blend_fwd")
    blend_fwd.launches += 1
    return unpad_raw(out, s_dim, width)


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
            f = lane_features(feat, idx, m)                   # (g, K, d)
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
    per-instance gradient rows (M, 10 + S) by sorted position. The tile
    ranges tile [0, ends[-1]) in order, as the binning gives them."""
    if not _nvcc.is_cuda(feat):
        return blend_bwd_plain(feat, starts, ends, raw, grad, grid_x)
    s_dim = _check_kernel_inputs(feat, starts, ends, raw, grad)
    num_tiles = starts.shape[0]
    if raw.shape != (num_tiles, PIX, s_dim + 7) or raw.shape != grad.shape:
        raise ValueError(f"raw and grad of shape {(num_tiles, PIX, s_dim + 7)}"
                         f" expected, got {tuple(raw.shape)} and "
                         f"{tuple(grad.shape)}")
    starts = starts.contiguous()
    ends = ends.contiguous()

    def run(f, r, g):
        return _blend_bwd_launch(f, starts, ends, r, g, grid_x)

    if s_dim > S_MAX:
        return _bwd_in_groups(feat, raw, grad, S_MAX, run)
    return run(feat, raw, grad)


def _blend_bwd_launch(feat, starts, ends, raw, grad,
                      grid_x: int) -> torch.Tensor:
    """One launch of the instance that holds feat's width (S <= S_MAX)."""
    s_dim = feat.shape[0] - 10
    width = kernel_width(s_dim)
    num_tiles = starts.shape[0]
    lib = _nvcc.library("blend_bwd", _BWD_SIGNATURES)
    feat = pad_feat(feat, width).contiguous()
    raw = pad_raw(raw, s_dim, width).contiguous()
    grad = pad_raw(grad, s_dim, width).contiguous()
    # the kernel writes every row, zeros where no pixel blends
    rows = torch.empty((feat.shape[1], feat.shape[0]), dtype=torch.float32,
                       device=feat.device)
    _nvcc.check(lib.goi_blend_bwd(
        width, feat.data_ptr(), feat.shape[1], starts.data_ptr(),
        ends.data_ptr(), num_tiles, grid_x, raw.data_ptr(), grad.data_ptr(),
        rows.data_ptr(), _nvcc.stream()), "blend_bwd")
    blend_bwd.launches += 1
    return unpad_rows(rows, s_dim, width)


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


def reduce_rows(rows: torch.Tensor, reduce: str, gid: torch.Tensor,
                n_gauss: int, perm=None, keys=None,
                dense: bool = False) -> torch.Tensor:
    """Per-instance rows (M, d) by sorted position -> per-Gaussian sums
    (n_gauss, d) by `reduce`: 'chain' (perm = the binning's sort_slots,
    keys = tiles_touched; `dense` fuses its prefix and read-out) or
    'scatter' (by gid)."""
    if reduce == "chain":
        return reduce_chain(rows, perm, _chain_bounds(keys, rows.shape[0]),
                            dense=dense)
    return reduce_scatter(rows, gid, n_gauss)


class _BlendCore(torch.autograd.Function):
    """pack + tiled blend under one autograd node (the role of
    pallas_blend._blend_core's custom VJP). The backward runs the
    backward kernel and then `reduce_rows` with the binning's `perm` and
    `keys` for `reduce`."""

    @staticmethod
    def forward(ctx, mean2d, conic, opacity, color, semantics, depth, gid,
                starts, ends, grid_x, reduce, dense, perm, keys):
        feat = pack(mean2d, conic, opacity, color, semantics, depth, gid)
        raw = blend_fwd(feat, starts, ends, grid_x)
        ctx.grid_x, ctx.reduce, ctx.dense = grid_x, reduce, dense
        ctx.n_gauss, ctx.s_dim = mean2d.shape[0], semantics.shape[-1]
        ctx.save_for_backward(feat, starts, ends, raw, gid, perm, keys)
        return raw

    @staticmethod
    def backward(ctx, grad_raw):
        feat, starts, ends, raw, gid, perm, keys = ctx.saved_tensors
        rows = blend_bwd(feat, starts, ends, raw, grad_raw, ctx.grid_x)
        with span("blend.reduce"):
            acc = reduce_rows(rows, ctx.reduce, gid, ctx.n_gauss, perm,
                              keys, ctx.dense)
        s = ctx.s_dim
        return (acc[:, 0:2], acc[:, 2:5], acc[:, 5], acc[:, 6:9],
                acc[:, 9:9 + s], acc[:, 9 + s],
                None, None, None, None, None, None, None, None)


def reduce_inputs(sp: Splats, binning: Binning, reduce: str):
    """(perm, keys) of `reduce_rows` for `reduce` on this binning;
    raises where the binning lacks what the reduce needs."""
    if reduce not in ("scatter", "chain"):
        raise ValueError(f"unknown reduce {reduce!r} (resolve 'auto' "
                         f"before calling)")
    if reduce == "chain":
        if binning.sort_slots is None:
            raise ValueError("reduce='chain' needs bin_splats_chunked("
                             "..., export_perm=True)")
        return binning.sort_slots, sp.tiles_touched
    return None, None


def blend_tiles_cuda(sp: Splats, binning: Binning, bg: torch.Tensor, *,
                     grid_x: int, reduce: str, dense: bool = False):
    """Per-tile images: color (T,256,3), semantics (T,256,S),
    depth (T,256), alpha (T,256). `reduce` (already resolved) picks the
    backward's instance -> Gaussian reduction: 'scatter' | 'chain'
    ('chain' needs export_perm=True; `dense`, chain only, fuses its
    prefix and boundary read-out). While armed, counts the forward's
    walked and blended pairs (blend.walked, blend.blended: raw's
    per-pixel counts summed in float64)."""
    perm, keys = reduce_inputs(sp, binning, reduce)
    if dense and reduce != "chain":
        raise ValueError("dense needs reduce='chain'")
    s = sp.semantics.shape[-1]
    raw = _BlendCore.apply(sp.mean2d, sp.conic, sp.opacity, sp.color,
                           sp.semantics, sp.depth, binning.point_list,
                           binning.tile_start, binning.tile_end, grid_x,
                           reduce, dense, perm, keys)
    if armed():
        pairs = raw.detach()[..., 5 + s:7 + s].sum((0, 1),
                                                   dtype=torch.float64)
        count("blend.walked", pairs[0])
        count("blend.blended", pairs[1])
    return composite(raw, bg, s)


def composite(raw: torch.Tensor, bg: torch.Tensor, s: int):
    """Raw blend output (T, 256, 4 + S + 3) -> color with the background
    (T,256,3), semantics (T,256,S), depth (T,256), alpha (T,256)."""
    t_final = raw[:, :, 4 + s]
    color = raw[:, :, :3] + t_final[:, :, None] * bg[None, None, :]
    return color, raw[:, :, 3:3 + s], raw[:, :, 3 + s], 1.0 - t_final
