"""From-scratch RGB 3DGS training (the upstream-Inria loop the reference
builds on: ref:scene/gaussian_model.py:163-182 optimizers and the
(1-l)*L1 + l*(1-SSIM) photometric objective, ref:train.py:137-140,
lambda_dssim ref:arguments/__init__.py:77).

Counterpart of goi_tpu/train/rgb.py. A step renders a camera, takes the
photometric loss and its gradients (the screen-space mean2d gradient
too, through a zero `mean2d_offset` that requires grad, for the
densification stats) and updates one Adam group per attribute. PyTorch
runs the step eagerly and updates the state in place. Densify and prune
run every `densification_interval` steps on the fixed-capacity scene
(train/densify.py); the SH degree steps up every 1000 steps
(ref:train.py:117-119).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from goi_tpu_torch.core.camera import Camera
from goi_tpu_torch.core.scene import GaussianScene
from goi_tpu_torch.eval.metrics import l1_loss, ssim
from goi_tpu_torch.raster.render import RasterConfig, render
from goi_tpu_torch.train.densify import (DensifyStats, add_stats,
                                         densify_and_prune, grow_capacity,
                                         reset_opacity)
from goi_tpu_torch.train.distill import _rebudget
from goi_tpu_torch.train.optim import (OptimConfig,
                                       make_full_training_optimizer,
                                       set_scheduled_lr)


@dataclasses.dataclass
class RGBTrainState:
    scene: GaussianScene
    opt: torch.optim.Adam
    stats: DensifyStats
    step: int = 0


def rgb_loss(scene: GaussianScene, cam: Camera, gt_image: torch.Tensor,
             bg: torch.Tensor, raster_cfg: RasterConfig,
             lambda_dssim: float,
             mean2d_offset: Optional[torch.Tensor] = None):
    """(loss, aux): the photometric loss of one render; aux holds the L1
    term, the radii and the budget counters."""
    out = render(scene, cam, bg, raster_cfg, mean2d_offset=mean2d_offset)
    img = out["render"]
    ll1 = l1_loss(img, gt_image)
    loss = (1.0 - lambda_dssim) * ll1 \
        + lambda_dssim * (1.0 - ssim(img, gt_image))
    return loss, {"l1": ll1, "radii": out["radii"],
                  "num_slots": out["num_slots"],
                  "num_instances": out["num_instances"]}


def create_rgb_trainer(cfg: OptimConfig, raster_cfg: RasterConfig,
                       spatial_lr_scale: float = 1.0):
    """Returns (init_fn, step_fn, densify_fn). The xyz schedule is scaled
    by the camera extent (ref:scene/gaussian_model.py:169,179-182).

    init_fn(scene) copies the scene's parameters into fresh leaves, so
    the caller's scene stays as it was. step_fn(state, cam, gt_image, bg)
    and densify_fn(state, generator, extent, max_screen_size=0) update
    the state in place and return it with their aux or info dict."""

    def init_fn(scene: GaussianScene) -> RGBTrainState:
        scene = scene.with_params({k: v.detach().clone().requires_grad_()
                                   for k, v in scene.params().items()})
        return RGBTrainState(
            scene=scene,
            opt=make_full_training_optimizer(cfg, spatial_lr_scale,
                                             scene.params()),
            stats=DensifyStats.create(scene.capacity, device=scene.device))

    def step_fn(state: RGBTrainState, cam: Camera, gt_image: torch.Tensor,
                bg: torch.Tensor) -> Tuple[RGBTrainState, dict]:
        params = list(state.scene.params().values())
        for p in params:
            p.grad = None
        offset = torch.zeros((state.scene.capacity, 2),
                             device=state.scene.device, requires_grad=True)
        loss, aux = rgb_loss(state.scene, cam, gt_image, bg, raster_cfg,
                             cfg.lambda_dssim, mean2d_offset=offset)
        loss.backward()
        # an attribute the render did not read gets a zero gradient: Adam
        # skips a None one, and its step count would fall behind optax's
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        # gnorm is reported on the RAW gradients (a NaN here means a
        # fault in the render backward); the applied ones are sanitised,
        # so that one degenerate sample cannot poison the Adam moments
        gnorm = torch.sqrt(sum(torch.sum(p.grad * p.grad) for p in params))
        for p in params:
            torch.nan_to_num_(p.grad, nan=0.0, posinf=0.0, neginf=0.0)
        set_scheduled_lr(state.opt, state.step)
        state.opt.step()
        state.stats = add_stats(state.stats, offset.grad, aux["radii"],
                                cam.width, cam.height)
        state.step += 1
        return state, {"loss": loss.detach(), "l1": aux["l1"].detach(),
                       "radii_max": aux["radii"].max(),
                       "num_slots": aux["num_slots"],
                       "num_instances": aux["num_instances"],
                       "gnorm": gnorm}

    def densify_fn(state: RGBTrainState, generator: torch.Generator,
                   extent: float, max_screen_size: int = 0
                   ) -> Tuple[RGBTrainState, dict]:
        state.scene, state.opt, state.stats, info = densify_and_prune(
            state.scene, state.opt, state.stats, generator,
            grad_threshold=cfg.densify_grad_threshold,
            min_opacity=0.005, extent=extent,
            percent_dense=cfg.percent_dense,
            max_screen_size=max_screen_size)
        return state, info

    return init_fn, step_fn, densify_fn


class _Counters:
    """A step's (num_slots, num_instances), copied to the host behind the
    step on the card's stream: reading them waits for that step only,
    not for the steps queued after it."""

    def __init__(self, aux: dict):
        c = torch.stack([aux["num_slots"], aux["num_instances"]]).to(
            torch.int64)
        self.event = None
        if c.is_cuda:
            self.host = torch.empty(2, dtype=torch.int64, pin_memory=True)
            self.host.copy_(c, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = c

    def read(self) -> Tuple[int, int]:
        if self.event is not None:
            self.event.synchronize()
        slots, ninst = self.host.tolist()
        return slots, ninst


def train_rgb(
    scene: GaussianScene,
    cameras: List[Camera],
    images,                        # list of (3, H, W) arrays or tensors
    *,
    cfg: Optional[OptimConfig] = None,
    raster_cfg: Optional[RasterConfig] = None,
    iterations: int = 7000,
    scene_extent: float = 1.0,
    white_background: bool = False,
    seed: int = 0,
    log_every: int = 200,
    callback: Optional[Callable] = None,
    return_raster_cfg: bool = False,
):
    """Host loop of the upstream trainer: random camera order per epoch
    from np.random.default_rng(seed), SH step-up every 1000 steps,
    densify every `densification_interval` steps inside
    (densify_from_iter, densify_until_iter] (max screen size 20 after
    the first opacity reset), capacity growth by max(1.5 cap, cap +
    1024) when a densify overflows, and the opacity reset every
    `opacity_reset_interval` steps. The split noise comes from one
    torch.Generator on the scene's device, seeded with `seed`.

    Every step checks the instance budget against the PREVIOUS step's
    counters (one step of slack: the host never waits on the step it
    has just queued; past the budget instances are truncated and the
    loss collapses) and grows it with distill's `_rebudget`; the last
    step's counters are folded in before returning. With
    `return_raster_cfg=True` returns (state, raster_cfg), the grown
    config, which final renders must use."""
    cfg = cfg or OptimConfig(iterations=iterations)
    raster_cfg = raster_cfg or RasterConfig()
    init_fn, step_fn, densify_fn = create_rgb_trainer(
        cfg, raster_cfg, spatial_lr_scale=scene_extent)

    state = init_fn(scene)
    dev = scene.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    bg = torch.ones(3, device=dev) if white_background \
        else torch.zeros(3, device=dev)

    def over_budget(slots, ninst):
        return max(slots, ninst) > raster_cfg.max_instances

    rng = np.random.default_rng(seed)
    stack: list = []
    pending: Optional[_Counters] = None   # the PREVIOUS step's counters
    for it in range(1, iterations + 1):
        if it % 1000 == 0:
            state.scene = state.scene.one_up_sh_degree()
        if not stack:
            stack = list(rng.permutation(len(cameras)))
        ci = int(stack.pop())
        gt = torch.as_tensor(images[ci], dtype=torch.float32, device=dev)
        state, aux = step_fn(state, cameras[ci], gt, bg)
        if cfg.densify_from_iter < it <= cfg.densify_until_iter \
                and it % cfg.densification_interval == 0:
            mss = 20 if it > cfg.opacity_reset_interval else 0
            state, dinfo = densify_fn(state, gen, scene_extent, mss)
            # a densifying scene can outgrow its capacity: grow it
            # instead of dropping the new rows
            overflow = int(dinfo["overflow"])
            if overflow > 0:
                cap = state.scene.capacity
                new_cap = max(int(cap * 1.5), cap + 1024)
                print(f"[goi_tpu_torch] densify overflow ({overflow} "
                      f"dropped); growing capacity {cap} -> {new_cap}")
                state.scene, state.opt, state.stats = grow_capacity(
                    state.scene, state.opt, state.stats, new_cap)
        prev, pending = pending, _Counters(aux)
        slots, ninst = prev.read() if prev is not None else (0, 0)
        if over_budget(slots, ninst):
            raster_cfg = _rebudget(raster_cfg, slots, ninst)
            _, step_fn, densify_fn = create_rgb_trainer(
                cfg, raster_cfg, spatial_lr_scale=scene_extent)
        if it % cfg.opacity_reset_interval == 0:
            state.scene, state.opt = reset_opacity(state.scene, state.opt)
        if it % log_every == 0:
            print(f"iter {it}: loss {float(aux['loss']):.5f} "
                  f"l1 {float(aux['l1']):.5f} "
                  f"n_valid {int(state.scene.num_valid)} "
                  f"slots {slots} radii_max {int(aux['radii_max'])}",
                  flush=True)
        if callback is not None:
            callback(it, state, aux)
    # the check above never sees the last step's counters: fold them in,
    # so that the returned raster_cfg holds for the final renders
    if pending is not None:
        slots, ninst = pending.read()
        if over_budget(slots, ninst):
            raster_cfg = _rebudget(raster_cfg, slots, ninst)
    if return_raster_cfg:
        return state, raster_cfg
    return state
