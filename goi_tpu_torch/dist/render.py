"""Sharded, differentiable render: Gaussian shards x tile-row slices.

Counterpart of goi_tpu/dist/render.py (`_exchange_rows`,
`render_sharded`). Each rank of the mesh's 'model' axis

  1. preprocesses its own Gaussian shard (with autograd),
  2. exchanges the screen-space splats: exchange="gather" gathers every
     rank's splats to every rank (collectives.all_gather_rows, whose
     backward returns each splat's gradient to its owner, summed over the
     ranks in order); exchange="rows" sends each rank only the splats
     whose rect meets its tile rows (`_exchange_rows`, one all-to-all of
     fixed-size packs), so a rank holds ~N/D rows instead of N;
  3. bins and blends only its slice of tile rows [row0, row0 + gy_local)
     with the one-card kernels (raster/render.py `_bin_and_blend`, the
     reduce of the config) at the budget max_instances // D;
  4. joins the slabs into the frame (collectives.gather_frame_rows).

The splats are resliced to the rank's rows as the JAX package does: the
mean shifts up by row0 * TILE, the rect is clipped to the slice,
tiles_touched becomes the clipped rect area and the cell-select table is
dropped (cell_sel = -1: the rect walk with the in-stream cull). Tile rows
are padded to a multiple of D with rows below the frame. The overflow
counters (num_slots, max_tile_depth, num_instances, the rows exchange's
demand) are the max over the ranks, to hold against local_budget and
exchange_cap. The floats travel as one (n, 10 + S) tensor and the
integers as one (n, 7) int32 tensor (`valid` among them: no bool
collectives).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from goi_tpu_torch.core.camera import Camera
from goi_tpu_torch.core.scene import GaussianScene
from goi_tpu_torch.dist.collectives import (all_gather_rows, all_reduce_max,
                                            all_to_all_rows, gather_frame_rows,
                                            gather_parts, pack_rows,
                                            swap_blocks)
from goi_tpu_torch.dist.mesh import Mesh
from goi_tpu_torch.raster.blend import tiles_to_image
from goi_tpu_torch.raster.preprocess import TILE, Splats, preprocess
from goi_tpu_torch.raster.render import (RasterConfig, _bin_and_blend,
                                         _check_config, _effective_reduce,
                                         _grid)


def _floats(sp: Splats) -> torch.Tensor:
    """(n, 10 + S): mean2d, depth, conic, opacity, color, semantics."""
    return torch.cat([sp.mean2d, sp.depth[:, None], sp.conic,
                      sp.opacity[:, None], sp.color, sp.semantics], 1)


def _ints(sp: Splats) -> torch.Tensor:
    """(n, 7) int32: radius, rect_min, rect_max, tiles_touched, valid."""
    return torch.cat([sp.radius[:, None], sp.rect_min, sp.rect_max,
                      sp.tiles_touched[:, None],
                      sp.valid[:, None].to(torch.int32)], 1)


def _splats(f: torch.Tensor, i: torch.Tensor) -> Splats:
    """_floats / _ints rows -> Splats without a cell-select table."""
    return Splats(
        mean2d=f[:, 0:2], depth=f[:, 2], conic=f[:, 3:6], opacity=f[:, 6],
        color=f[:, 7:10], semantics=f[:, 10:], radius=i[:, 0],
        rect_min=i[:, 1:3], rect_max=i[:, 3:5], tiles_touched=i[:, 5],
        valid=i[:, 6] > 0,
        cell_sel=torch.full((f.shape[0], 2), -1.0, device=f.device))


def _exchange_rows(sp: Splats, group, n_dev: int, gy_local: int, cap: int):
    """Tile-row-bucketed exchange: for each destination d, this rank's
    splats whose rect meets d's tile rows [d * gy_local, (d + 1) *
    gy_local), in local index order, at most `cap` of them (the lowest
    indices), then one all-to-all. The packs join source-major, so the
    kept rows keep the global index order and the tile sort breaks ties
    as the one-card path does. Returns (Splats of n_dev * cap rows, the
    worst (source, destination) demand over the group)."""
    row_lo, row_hi = sp.rect_min[:, 1], sp.rect_max[:, 1]
    has_area = sp.valid & (sp.rect_max[:, 0] > sp.rect_min[:, 0]) \
        & (row_hi > row_lo)
    d_ix = torch.arange(n_dev, device=row_lo.device)[:, None]
    member = has_area[None, :] & (row_lo[None, :] < (d_ix + 1) * gy_local) \
        & (row_hi[None, :] > d_ix * gy_local)                 # (D, n_loc)
    pos = torch.cumsum(member.to(torch.int64), 1) - 1
    demand = pos[:, -1] + 1
    keep = member & (pos < cap)
    dest, src = torch.nonzero(keep, as_tuple=True)
    idx = torch.zeros((n_dev, cap), dtype=torch.int64, device=row_lo.device)
    ok = torch.zeros((n_dev, cap), dtype=torch.bool, device=row_lo.device)
    idx[dest, pos[dest, src]] = src
    ok[dest, pos[dest, src]] = True
    f = all_to_all_rows(pack_rows(_floats(sp), idx, ok), group)
    i = swap_blocks(pack_rows(_ints(sp), idx, ok), group)
    return _splats(f, i), all_reduce_max(demand.max(), group)


def _reslice(full: Splats, row0: int, gy_local: int) -> Splats:
    """The splats in the frame of tile rows [row0, row0 + gy_local)."""
    rmin_y = torch.clamp(full.rect_min[:, 1] - row0, 0, gy_local)
    rmax_y = torch.clamp(full.rect_max[:, 1] - row0, 0, gy_local)
    area = (full.rect_max[:, 0] - full.rect_min[:, 0]) * (rmax_y - rmin_y)
    shift = torch.tensor([0.0, float(row0 * TILE)], device=area.device)
    return dataclasses.replace(
        full,
        mean2d=full.mean2d - shift[None, :],
        rect_min=torch.stack([full.rect_min[:, 0], rmin_y], -1),
        rect_max=torch.stack([full.rect_max[:, 0], rmax_y], -1),
        tiles_touched=torch.where(full.valid, area, torch.zeros_like(area)),
        valid=full.valid & (area > 0))


def render_sharded(scene: GaussianScene, cam: Camera, bg, config: RasterConfig,
                   mesh: Mesh, *, axis: str = "model",
                   exchange: str = "gather",
                   exchange_cap: Optional[int] = None) -> dict:
    """Differentiable render of the scene sharded over `axis` (this
    rank's rows, dist.mesh.shard_scene); the camera and background are
    the same on every rank. Returns render()'s dict (the frame, the
    gathered radii and visibility, and num_instances, num_slots and
    max_tile_depth as the max over the ranks) plus local_budget
    (max_instances // D): num_slots above it means a rank truncated its
    instances; rebudget as for render().

    exchange: "gather" (every splat to every rank, ~N rows a rank) or
    "rows" (the tile-row-bucketed all-to-all, D * exchange_cap rows a
    rank; adds exchange_demand, the worst pack demand, exchange_cap and
    exchange_rows_per_device). exchange_cap defaults to ceil(2 N_local /
    D), at least 64; demand above it means rows were dropped (the
    highest local indices first): call again with a larger cap."""
    _check_config(config)
    if config.backend != "cuda":
        raise ValueError(f"render_sharded runs the 'cuda' backend, got "
                         f"{config.backend!r}")
    group, n_dev = mesh.group(axis), mesh.shape[axis]
    grid_x, grid_y = _grid(cam)
    # tile rows padded to a multiple of D: the padding lies below the
    # frame, no splat touches it, and the final crop drops it
    gy_local = -(-grid_y // n_dev)
    local_budget = config.max_instances // n_dev
    n_local = scene.valid.shape[0]
    if exchange == "rows":
        cap = exchange_cap or max(-(-2 * n_local // n_dev), 64)
    elif exchange != "gather":
        raise ValueError(f"unknown exchange {exchange!r}")

    sp = preprocess(scene, cam)
    if exchange == "rows":
        full, demand = _exchange_rows(sp, group, n_dev, gy_local, cap)
    else:
        full = _splats(all_gather_rows(_floats(sp), group),
                       gather_parts(_ints(sp), group).reshape(-1, 7))
        demand = torch.zeros((), dtype=torch.int64, device=sp.depth.device)
    local = _reslice(full, mesh.index(axis) * gy_local, gy_local)
    local_cfg = dataclasses.replace(config, max_instances=local_budget)
    tiles, binning = _bin_and_blend(local, local_cfg,
                                    _effective_reduce(config), bg, grid_x,
                                    gy_local)
    color_t, sem_t, depth_t, alpha_t = tiles
    s = sem_t.shape[-1]
    slab = tiles_to_image(
        torch.cat([color_t, sem_t, depth_t[..., None], alpha_t[..., None]],
                  -1), grid_x, gy_local, gy_local * TILE, cam.width)
    frame = gather_frame_rows(slab, group)[:, :cam.height]
    radii = gather_parts(sp.radius, group).reshape(-1)
    worst = all_reduce_max(torch.stack([
        binning.num_instances.long(), binning.num_slots.long(),
        torch.max(binning.tile_end - binning.tile_start).long(),
        demand.long()]), group).to(torch.int32)
    out = {
        "render": frame[:3], "semantics": frame[3:3 + s],
        "depth": frame[3 + s:4 + s], "alpha": frame[4 + s:5 + s],
        "radii": radii, "visibility_filter": radii > 0,
        "num_instances": worst[0], "num_slots": worst[1],
        "max_tile_depth": worst[2], "local_budget": local_budget,
    }
    if exchange == "rows":
        out.update(exchange_demand=worst[3], exchange_cap=cap,
                   exchange_rows_per_device=n_dev * cap)
    return out
