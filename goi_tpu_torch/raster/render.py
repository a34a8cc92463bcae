"""Public render API.

Counterpart of goi_tpu/raster/render.py: preprocess -> chunked binning
-> tiled blend, returning the reference render() contract
(ref:gaussian_renderer/__init__.py:99-105) plus the budget counters.
The frame runs on the device of the scene's tensors: the hand-written
CUDA kernels for CUDA tensors, their plain versions for CPU tensors.
`render` is differentiable: torch autograd through preprocess's
composition where a gradient flows to the geometry (as the JAX package
uses JAX autodiff there, PARITY.md N5; else its kernel), binning under
no_grad, and the blend's own backward (raster/cuda_blend.py) with the
reduce that `_effective_reduce` picks. `trace` lifts a 2D feature map
onto the Gaussians through the fused blend + lift kernel
(raster/cuda_trace.py), forward only. `render_batch` renders a list of
views, or a stacked camera, on one budget.
"""

from __future__ import annotations

import dataclasses
import pickle
from typing import Optional

import torch

from goi_tpu_torch.core.camera import Camera, unstack_cameras
from goi_tpu_torch.core.scene import GaussianScene
from goi_tpu_torch.raster.binning import bin_splats_chunked
from goi_tpu_torch.raster.blend import tiles_to_image
from goi_tpu_torch.raster.cuda_blend import K as BLEND_K
from goi_tpu_torch.raster.cuda_blend import (blend_tiles_cuda, composite,
                                             pack, reduce_inputs,
                                             reduce_rows)
from goi_tpu_torch.raster.cuda_trace import trace_fwd, trace_fwd_plain
from goi_tpu_torch.raster.preprocess import TILE, preprocess
from goi_tpu_torch.utils.profiling import armed, count, span, span_backward


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    """Rasterization budgets and options.

    max_instances: instance (Gaussian x tile) buffer size; must cover
        sum(max(tiles_touched, 1)). The CUDA reference allocates this per
        frame (ref:rasterizer_impl.cu:155-230); the port keeps the JAX
        package's fixed budget and overflow counters.
    backend: 'cuda' (the kernels on CUDA tensors, their plain versions
        on CPU tensors) or 'reference' (the per-pixel oracle).
    reduce: instance->Gaussian gradient reduction of the backward,
        resolved by _effective_reduce: 'auto' | 'scatter' | 'chain'
        ('chain' also makes the binning export its sort permutation).
    cull: exact ellipse/tile overlap cull in binning (output-exact).
    dense_reduce: fuse the 'chain' reduce's block prefix and its read-out
        at the segment bounds into one kernel (csrc/prefix_boundary.cu;
        the same bits, less memory traffic). Off by default, as the JAX
        package's GOI_DENSE_REDUCE; valid with the 'chain' reduce only.
        It applies to render's backward and to trace's lift.
    debug: after each render, test `render` and `semantics` for
        non-finite values (one host sync) and, on one, pickle the
        preprocess output as a dict of numpy arrays to
        `snapshot_fw.dump` in the working directory (the role of the
        reference's --debug snapshot, ref:diff_gaussian_rasterization/
        __init__.py:112-119).
    """

    max_instances: int = 1 << 20
    backend: str = "cuda"
    reduce: str = "auto"
    cull: bool = True
    dense_reduce: bool = False
    debug: bool = False


def _grid(cam: Camera):
    return (cam.width + TILE - 1) // TILE, (cam.height + TILE - 1) // TILE


# 'auto' picks the chain reduce at and above this budget (the JAX
# package's measured crossover, raster/render.py there)
AUTO_CUMSUM_MIN = 1 << 19


def _effective_reduce(config: RasterConfig) -> str:
    """Resolve reduce='auto' against the static budget, as the JAX
    package does in its chunked layout: 'chain' from AUTO_CUMSUM_MIN
    slots, else 'scatter'. dense_reduce needs the resolution to be
    'chain'."""
    if config.reduce != "auto":
        reduce = config.reduce
    else:
        reduce = ("chain" if config.max_instances >= AUTO_CUMSUM_MIN
                  else "scatter")
    if config.dense_reduce and reduce != "chain":
        raise ValueError(f"dense_reduce=True needs the 'chain' reduce; "
                         f"reduce={config.reduce!r} resolves to {reduce!r}")
    return reduce


def _assemble_out(tiles, sp, binning, cam: Camera, grid_x: int,
                  grid_y: int):
    color_t, sem_t, depth_t, alpha_t = tiles
    h, w = cam.height, cam.width
    return {
        "render": tiles_to_image(color_t, grid_x, grid_y, h, w),
        "semantics": tiles_to_image(sem_t, grid_x, grid_y, h, w),
        "depth": tiles_to_image(depth_t[..., None], grid_x, grid_y, h, w),
        "alpha": tiles_to_image(alpha_t[..., None], grid_x, grid_y, h, w),
        "radii": sp.radius,
        "visibility_filter": sp.radius > 0,
        "num_instances": binning.num_instances,
        # slots demanded; > config.max_instances means truncation
        "num_slots": binning.num_slots,
        # deepest tile segment (informational: the blend has no cap)
        "max_tile_depth": torch.max(binning.tile_end - binning.tile_start),
    }


BUDGET_QUANTUM = 4096  # multiple of the blend's K


def suggest_budgets(scene: GaussianScene, cams, *, margin: float = 1.5,
                    minimum: int = 1 << 15) -> tuple:
    """(max_instances, max_instances): the expansion demand
    sum(max(tiles_touched, 1)) (one forced slot per Gaussian) of the
    worst frame of `cams`, with `margin` headroom, rounded up to
    BUDGET_QUANTUM. The budget comes twice, as the JAX package's budget
    pair does in its chunked layout, because callers unpack two values;
    suggest_instance_budget returns it once."""
    if not isinstance(cams, (list, tuple)):
        cams = [cams]
    worst = 0
    with torch.no_grad():
        for cam in cams:
            counts = torch.clamp(preprocess(scene, cam).tiles_touched, min=1)
            worst = max(worst, int(counts.sum()))
    q = BUDGET_QUANTUM
    want = max(int(worst * margin) + 1, minimum)
    mi = (want + q - 1) // q * q
    return mi, mi


def suggest_instance_budget(scene: GaussianScene, cams, *,
                            margin: float = 1.5,
                            minimum: int = 1 << 15) -> int:
    """The one budget of suggest_budgets."""
    return suggest_budgets(scene, cams, margin=margin, minimum=minimum)[0]


def image_to_tiles(img: torch.Tensor, grid_x: int,
                   grid_y: int) -> torch.Tensor:
    """(C, H, W) -> (T, 256, C), zero-padding to the tile grid."""
    c, h, w = img.shape
    ph, pw = grid_y * TILE - h, grid_x * TILE - w
    img = torch.nn.functional.pad(img, (0, pw, 0, ph))
    img = img.reshape(c, grid_y, TILE, grid_x, TILE)
    return img.permute(1, 3, 2, 4, 0).reshape(grid_y * grid_x,
                                              TILE * TILE, c)


def render(scene: GaussianScene, cam: Camera, bg_color,
           config: RasterConfig = RasterConfig(), *,
           scaling_modifier: float = 1.0,
           override_color: Optional[torch.Tensor] = None,
           mean2d_offset: Optional[torch.Tensor] = None,
           semantic_masks: Optional[torch.Tensor] = None,
           gaussian_mask: Optional[torch.Tensor] = None):
    """semantic_masks gates the semantic channel only
    (ref:scene/gaussian_model.py:108-123); gaussian_mask hides Gaussians
    entirely (ref:gui/gs_renderer.py:315-321)."""
    if gaussian_mask is not None:
        scene = scene.replace(valid=scene.valid & gaussian_mask)
    if config.backend == "reference":
        from goi_tpu_torch.raster.reference import render_reference
        return render_reference(scene, cam, bg_color,
                                scaling_modifier=scaling_modifier,
                                override_color=override_color,
                                semantic_masks=semantic_masks,
                                mean2d_offset=mean2d_offset)
    _check_config(config)
    with span("render"):
        grid_x, grid_y = _grid(cam)
        with span("render.preprocess"):
            sp = preprocess(scene, cam, scaling_modifier=scaling_modifier,
                            override_color=override_color,
                            semantic_masks=semantic_masks)
        if mean2d_offset is not None:
            sp = dataclasses.replace(sp, mean2d=sp.mean2d + mean2d_offset)
        tiles, binning = _bin_and_blend(sp, config,
                                        _effective_reduce(config), bg_color,
                                        grid_x, grid_y)
        out = _assemble_out(tiles, sp, binning, cam, grid_x, grid_y)
        span_backward(out["semantics"], "render.backward")
    if config.debug and not bool(torch.isfinite(out["render"]).all()
                                 & torch.isfinite(out["semantics"]).all()):
        _dump_splats(sp)
    return out


DEBUG_DUMP = "snapshot_fw.dump"


def _dump_splats(sp) -> None:
    fields = {f.name: getattr(sp, f.name).detach().cpu().numpy()
              for f in dataclasses.fields(sp)}
    with open(DEBUG_DUMP, "wb") as f:
        pickle.dump(fields, f)
    print(f"[goi_tpu_torch] non-finite render output; rasterizer inputs "
          f"dumped to {DEBUG_DUMP}", flush=True)


def render_batch(scene: GaussianScene, cams, bg_color,
                 config: RasterConfig = RasterConfig(), **kw):
    """render() of each view in `cams` (a list of cameras or one stacked
    camera, core.camera.stack_cameras) on the one budget of `config`;
    every output stacked along a leading view axis (video paths, eval
    sweeps)."""
    outs = [render(scene, cam, bg_color, config, **kw)
            for cam in unstack_cameras(cams)]
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def _check_config(config: RasterConfig) -> None:
    if config.backend not in ("cuda", "reference"):
        raise ValueError(f"unknown backend {config.backend!r}")
    if config.reduce not in ("auto", "scatter", "chain"):
        raise ValueError(f"unknown reduce {config.reduce!r}")


def _bin(sp, config: RasterConfig, grid_x: int, grid_y: int, reduce: str):
    """The chunked binning of `config`; while armed, counts the sort's
    length (binning.sorted_slots) and the instances the blend walks
    (binning.kept: the tiles' ranges, the last tile's end)."""
    with span("render.binning"):
        binning = bin_splats_chunked(
            sp, grid_x=grid_x, grid_y=grid_y,
            max_instances=config.max_instances, chunk_k=BLEND_K,
            cull=config.cull, export_perm=(reduce == "chain"))
        if armed():
            count("binning.sorted_slots", config.max_instances)
            count("binning.kept",
                  (binning.tile_end - binning.tile_start).sum())
    return binning


def _bin_and_blend(sp, config: RasterConfig, reduce: str, bg_color,
                   grid_x: int, grid_y: int):
    """Binning (no gradient: integer stages) and the differentiable blend
    of preprocessed splats; returns (tiles, binning)."""
    with torch.no_grad():
        binning = _bin(sp, config, grid_x, grid_y, reduce)
    bg = torch.as_tensor(bg_color, dtype=torch.float32,
                         device=sp.mean2d.device)
    tiles = blend_tiles_cuda(sp, binning, bg, grid_x=grid_x, reduce=reduce,
                             dense=config.dense_reduce)
    return tiles, binning


def trace(scene: GaussianScene, cam: Camera, img_sem: torch.Tensor,
          bg_color, config: RasterConfig = RasterConfig(), *,
          scaling_modifier: float = 1.0,
          override_color: Optional[torch.Tensor] = None):
    """2D->3D feature lifting (ref:cuda_rasterizer/forward.cu:422-583,
    gaussian_renderer/__init__.py:107-192): walks the blend order and,
    for every blended instance with alpha > 0.005, adds the pixel's
    image feature to that Gaussian.

    img_sem: (S, H, W) per-pixel features to lift. Returns dict(render,
    gaussian_semantics (N, S), num_gsem (N,) int32, max_tile_depth,
    num_slots). num_gsem counts one hit per channel (hits * S), the
    reference's quirk (ref:forward.cu:521-526, PARITY.md N6). One
    preprocess and one binning serve the lift and the embedded render;
    the rows sum per Gaussian with the reduce that `_effective_reduce`
    picks (deterministic; hit counts travel as float32, exact below
    2^24). backend='reference' runs the kernel's plain version on any
    device. Forward only: runs under no_grad."""
    _check_config(config)
    s = img_sem.shape[0]
    if tuple(img_sem.shape[1:]) != (cam.height, cam.width):
        raise ValueError(f"img_sem (S, {cam.height}, {cam.width}) expected, "
                         f"got {tuple(img_sem.shape)}")
    reduce = _effective_reduce(config)
    fwd = trace_fwd_plain if config.backend == "reference" else trace_fwd
    grid_x, grid_y = _grid(cam)
    with torch.no_grad():
        sp = preprocess(scene, cam, scaling_modifier=scaling_modifier,
                        override_color=override_color)
        binning = _bin(sp, config, grid_x, grid_y, reduce)
        dev = scene.xyz.device
        # the ones channel counts hits; image_to_tiles zero-pads both it
        # and the features outside the image
        aug = torch.cat([img_sem.to(device=dev, dtype=torch.float32),
                         torch.ones((1, cam.height, cam.width),
                                    device=dev)])
        feat = pack(sp.mean2d, sp.conic, sp.opacity, sp.color,
                    sp.semantics, sp.depth, binning.point_list)
        raw, rows = fwd(feat, binning.tile_start, binning.tile_end,
                        image_to_tiles(aug, grid_x, grid_y), grid_x)
        lifted = reduce_rows(rows, reduce, binning.point_list,
                             sp.mean2d.shape[0],
                             *reduce_inputs(sp, binning, reduce),
                             dense=config.dense_reduce)
        bg = torch.as_tensor(bg_color, dtype=torch.float32, device=dev)
        tiles = composite(raw, bg, sp.semantics.shape[-1])
        out = _assemble_out(tiles, sp, binning, cam, grid_x, grid_y)
    return {
        "render": out["render"],
        "gaussian_semantics": lifted[:, :s],
        "num_gsem": lifted[:, s].to(torch.int32) * s,
        # informational: the walk has no per-tile cap
        "max_tile_depth": out["max_tile_depth"],
        "num_slots": binning.num_slots,
    }
