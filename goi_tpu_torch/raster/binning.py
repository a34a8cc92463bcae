"""Tile binning: duplicate Gaussians into the tiles they touch, ordered
by (tile, depth).

Counterpart of goi_tpu/raster/binning.py, chunked layout (the CUDA
pipeline's prefix scan + duplicateWithKeys + radix sort +
identifyTileRanges, ref:cuda_rasterizer/rasterizer_impl.cu:35-138,
279-322, with a static instance budget):

- instances expand in Gaussian-index order; every Gaussian keeps at
  least one slot (a sentinel when it touches no tile), so the stream's
  Gaussian ids are dense and non-decreasing;
- the slot -> Gaussian map and the per-Gaussian columns come from ONE
  feature-major expansion gather (raster/gather.py `expand_gather`: on
  a CUDA tensor a kernel that searches each slot's Gaussian in the
  bases, on a CPU tensor the JAX package's scatter + cummax + gather);
- an exact ellipse/tile overlap test drops instances no pixel of the
  tile can blend (output-exact);
- one stable sort on (tile, depth bits) with the Gaussian index as the
  tie-break, the order of the reference's stable radix sort;
- on overflow the stream truncates at `max_instances`; `num_slots`
  reports the true demand so callers rebudget.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from goi_tpu_torch.raster.gather import expand_gather
from goi_tpu_torch.raster.preprocess import TILE, Splats, cell_min_q

# 16^-k for the nibble extract; powers of two, exact in float32
_POW16_INV = [16.0 ** -k for k in range(6)]


def _decode_cell(sel_lo, sel_hi, local, x0, y0, w_i):
    """Instance-local index -> tile coords. Exact-count Gaussians
    (cell_sel >= 0) read the local-th nibble of the packed select table;
    fallback Gaussians (sel_lo < 0) walk the rect row-major (matching
    duplicateWithKeys, ref:cuda_rasterizer/rasterizer_impl.cu:70-95)."""
    fb = sel_lo < 0.0
    packed = torch.where(local < 6, sel_lo, sel_hi)
    shift = torch.where(local < 6, local, local - 6)
    sh = torch.clamp(shift, 0, 5)
    inv = torch.tensor(_POW16_INV, dtype=torch.float32, device=sel_lo.device)
    # nibble extract in exact float32 arithmetic (values < 16^6 < 2^24)
    c = torch.floor(packed * inv[sh.long()])
    c = (c - 16.0 * torch.floor(c / 16.0)).to(torch.int32)
    c = torch.clamp(c, 0, 8)
    # integer // and % floor toward -inf, as in JAX (local may be < 0 for
    # slots past an overflowing budget)
    tx_f = x0 + local % w_i
    ty_f = y0 + local // w_i
    tx = torch.where(fb, tx_f, x0 + c % 3)
    ty = torch.where(fb, ty_f, y0 + c // 3)
    return tx, ty


@dataclasses.dataclass
class Binning:
    point_list: torch.Tensor     # (max_instances,) int32 Gaussian ids
    tile_start: torch.Tensor     # (num_tiles,) int32
    tile_end: torch.Tensor       # (num_tiles,) int32, exclusive
    num_instances: torch.Tensor  # () int32 raw rect instance count
    num_slots: torch.Tensor      # () int32 slots demanded; > budget <=>
    #                              instances were truncated
    # exclusive prefix of per-tile chunk counts (chunks of K from
    # (start // K) * K): the backward's per-(tile, chunk) rows
    chunk_base: torch.Tensor     # (num_tiles,) int32
    # export_perm: sort_slots[p] = expansion index of the instance at
    # sorted position p; g_stream[r] = Gaussian owning expansion slot r
    sort_slots: Optional[torch.Tensor] = None   # (max_instances,) int32
    g_stream: Optional[torch.Tensor] = None     # (max_instances,) int32


def _expansion_table(sp: Splats, base: torch.Tensor,
                     counts_true: torch.Tensor) -> torch.Tensor:
    """The per-Gaussian columns the expansion gathers, feature-major
    (14, N) float32 (ints below 2^24 are exact)."""
    q_cut = torch.clamp(
        2.0 * torch.log(torch.clamp(sp.opacity, min=1e-12) * 255.0),
        min=0.0) * (1.0 + 1e-6)
    f32 = torch.float32
    cols = [
        sp.rect_min[:, 0].to(f32),                                # 0 x0
        sp.rect_min[:, 1].to(f32),                                # 1 y0
        torch.clamp(sp.rect_max[:, 0] - sp.rect_min[:, 0],
                    min=1).to(f32),                               # 2 w
        base.to(f32),                                             # 3 base
        counts_true.to(f32),                                      # 4 count
        sp.depth.to(f32),                                         # 5 depth
        sp.mean2d[:, 0], sp.mean2d[:, 1],                         # 6,7
        sp.conic[:, 0], sp.conic[:, 1], sp.conic[:, 2],           # 8-10
        q_cut,                                                    # 11
        sp.cell_sel[:, 0], sp.cell_sel[:, 1],                     # 12,13
    ]
    return torch.stack(cols, dim=0)


def _overlaps(rows, tx, ty):
    """The exact ellipse/tile overlap test of each instance (rows of the
    expansion table): False where no pixel of tile (tx, ty) can blend it.
    Non-positive-definite conics never blend; they are kept, to stay
    conservative."""
    px, py = rows[6], rows[7]
    ca, cb, cc = rows[8], rows[9], rows[10]
    lx = (tx * TILE).to(torch.float32) - px
    ly = (ty * TILE).to(torch.float32) - py
    min_q = cell_min_q(lx, lx + (TILE - 1), ly, ly + (TILE - 1), ca, cb, cc)
    pd = (ca > 0.0) & (cc > 0.0) & (ca * cc - cb * cb > 0.0)
    return (min_q <= rows[11]) | ~pd


def _sort_instances(tile, depth_bits, g_stream):
    """One stable sort on a combined key: tile in the high 32 bits, the
    signed depth bits biased by 2^31 in the low 32 (sentinel and culled
    slots can carry negative depth bits); stability keeps the expansion
    (Gaussian-index) order on ties. Returns (tile_sorted, perm, gid)."""
    key = (tile.long() << 32) + (depth_bits.long() + (1 << 31))
    key_sorted, perm = torch.sort(key, stable=True)
    return key_sorted >> 32, perm, g_stream[perm]


def _tile_ranges(tile_sorted, num_tiles: int):
    tids = torch.arange(num_tiles, device=tile_sorted.device)
    return (torch.searchsorted(tile_sorted, tids, right=False),
            torch.searchsorted(tile_sorted, tids, right=True))


def _expand_chunked(sp: Splats, *, grid_x: int, grid_y: int, n_inst: int,
                    cull: bool):
    """The expansion. Returns (tile, g_stream, depth_bits, raw_total,
    demand); demand counts the forced sentinel slot of every zero-count
    Gaussian."""
    num_tiles = grid_x * grid_y
    dev = sp.depth.device
    counts_true = sp.tiles_touched.long()
    counts = torch.clamp(counts_true, min=1)
    offsets = torch.cumsum(counts, 0)
    base = offsets - counts
    demand = offsets[-1]
    raw_total = counts_true.sum()

    table = _expansion_table(sp, base, counts_true)               # (14, N)
    # bases clamp to the last slot under overflow, so several Gaussians
    # can land there: the highest id owns it
    g_stream, rows = expand_gather(table, base, n_inst)           # (14, M)

    slots = torch.arange(n_inst, device=dev)
    x0 = rows[0].to(torch.int32)
    y0 = rows[1].to(torch.int32)
    w_i = rows[2].to(torch.int32)
    base_i = rows[3].to(torch.int32)
    count_i = rows[4].to(torch.int32)
    depth_bits = rows[5].view(torch.int32)
    local = slots.to(torch.int32) - base_i
    tx, ty = _decode_cell(rows[12], rows[13], local, x0, y0, w_i)
    keep = (slots < demand) & (local < count_i)
    if cull:
        keep = keep & _overlaps(rows, tx, ty)
    tile = torch.where(keep, ty * grid_x + tx,
                       torch.full_like(tx, num_tiles))
    return tile, g_stream, depth_bits, raw_total, demand


def bin_splats_chunked(sp: Splats, *, grid_x: int, grid_y: int,
                       max_instances: int, chunk_k: int, cull: bool = True,
                       export_perm: bool = False) -> Binning:
    """One contiguous tile-sorted stream; kernels walk each tile's
    [start, end). Sort order (the blend order) is a stable (tile,
    depth-bits) sort with Gaussian-index tie-break
    (ref:cuda_rasterizer/rasterizer_impl.cu:279-322)."""
    num_tiles = grid_x * grid_y
    tile, g_stream, depth_bits, raw_total, demand = _expand_chunked(
        sp, grid_x=grid_x, grid_y=grid_y, n_inst=max_instances, cull=cull)

    tile_sorted, perm, gid = _sort_instances(tile, depth_bits, g_stream)
    starts, ends = _tile_ranges(tile_sorted, num_tiles)
    walk = (starts // chunk_k) * chunk_k
    nch = torch.where(ends > starts, (ends - walk + chunk_k - 1) // chunk_k,
                      torch.zeros_like(ends))
    chunk_base = torch.cumsum(nch, 0) - nch
    i32 = torch.int32
    return Binning(
        point_list=gid, tile_start=starts.to(i32), tile_end=ends.to(i32),
        num_instances=raw_total.to(i32), num_slots=demand.to(i32),
        chunk_base=chunk_base.to(i32),
        sort_slots=perm.to(i32) if export_perm else None,
        g_stream=g_stream if export_perm else None)


def chunk_capacity(max_instances: int, num_tiles: int, chunk_k: int) -> int:
    """Static bound on the total chunk count of a chunked binning: every
    tile adds at most one boundary chunk beyond ceil(M/K)."""
    return max_instances // chunk_k + num_tiles + 1
