"""Semantic-field distillation training (the reference's core entry).

Counterpart of goi_tpu/train/distill.py, the form of ref:train.py:59-203:
a step renders a camera, decodes the semantic map, applies the 4-term
codebook loss and updates three parameter groups (Gaussian attributes /
decoder MLP / LUT). PyTorch runs the step eagerly: the render's backward
is the blend-backward kernel plus the deterministic reduce
(raster/cuda_blend.py), the rest is torch autograd. The state is
mutable: `train_step` updates it in place and returns it.
`create_distill_state` copies the tensors it trains, so the caller's
scene, decoder and LUT stay as they were (as JAX's would).
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from goi_tpu_torch.core.camera import Camera
from goi_tpu_torch.core.scene import GaussianScene
from goi_tpu_torch.raster.render import BUDGET_QUANTUM, RasterConfig, render
from goi_tpu_torch.semantic.codebook import SemanticDecoder, init_codebook
from goi_tpu_torch.semantic.losses import distillation_loss
from goi_tpu_torch.train.optim import (OptimConfig, make_scene_optimizer,
                                       scene_learning_rates,
                                       set_scheduled_lr)
from goi_tpu_torch.utils.logging import TensorBoardLogger
from goi_tpu_torch.utils.profiling import StepTimer, span

ANNEAL_STEP = 1000   # anneal_t is 1 before this step, 2 from it on


@dataclasses.dataclass
class DistillState:
    scene: GaussianScene
    decoder: SemanticDecoder
    lut: torch.Tensor
    opt_scene: Optional[torch.optim.Adam]
    opt_decoder: torch.optim.Adam
    opt_lut: torch.optim.Adam
    step: int = 0


def distill_loss(state: DistillState, cam: Camera,
                 gt_features: torch.Tensor, bg: torch.Tensor,
                 raster_cfg: RasterConfig
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The step's loss: render, decode, 4-term loss. gt_features is the
    camera's (C, H, W) APE feature map."""
    out = render(state.scene, cam, bg, raster_cfg)
    s, h, w = out["semantics"].shape
    sem_flat = out["semantics"].reshape(s, h * w).T
    gt_flat = gt_features.reshape(gt_features.shape[0], -1).T
    anneal_t = 1.0 if state.step < ANNEAL_STEP else 2.0
    with span("loss.forward"):
        loss, aux = distillation_loss(state.decoder, state.lut, sem_flat,
                                      gt_flat, anneal_t)
    return loss, dict(aux, num_slots=out["num_slots"],
                      num_instances=out["num_instances"])


def create_distill_state(
    scene: GaussianScene,
    decoder: SemanticDecoder,
    lut: torch.Tensor,
    cfg: OptimConfig,
    spatial_lr_scale: float = 1.0,
) -> Tuple[DistillState, Callable]:
    """State + the step function.

    Optimizers mirror ref:train.py:63-67: Adam(3e-3) on the MLP,
    Adam(1e-3) on the LUT, per-attribute Adam on the scene (only
    `semantics` by default)."""
    trained = scene_learning_rates(cfg, spatial_lr_scale)
    scene = scene.with_params({k: v.detach().clone().requires_grad_()
                               for k, v in scene.params().items()
                               if k in trained})
    decoder = copy.deepcopy(decoder)
    lut = lut.detach().clone().requires_grad_()
    state = DistillState(
        scene=scene, decoder=decoder, lut=lut,
        opt_scene=make_scene_optimizer(cfg, spatial_lr_scale,
                                       scene.params()),
        opt_decoder=torch.optim.Adam(decoder.parameters(), lr=3e-3),
        opt_lut=torch.optim.Adam([lut], lr=1e-3))

    def train_step(state: DistillState, cam: Camera,
                   gt_features: torch.Tensor, bg: torch.Tensor,
                   raster_cfg: RasterConfig
                   ) -> Tuple[DistillState, Dict[str, torch.Tensor]]:
        with span("distill.step"):
            opts = [o for o in (state.opt_scene, state.opt_decoder,
                                state.opt_lut) if o is not None]
            for o in opts:
                o.zero_grad(set_to_none=True)
            loss, aux = distill_loss(state, cam, gt_features, bg,
                                     raster_cfg)
            with span("distill.backward"):
                loss.backward()
            with span("optim"):
                set_scheduled_lr(state.opt_scene, state.step)
                for o in opts:
                    o.step()
            state.step += 1
            return state, {k: v.detach() for k, v in aux.items()}

    return state, train_step


def _rebudget(raster_cfg: RasterConfig, slots: int,
              ninst: int) -> RasterConfig:
    """Grow the instance budget to 1.5x the demand, quantum-rounded (the
    JAX package's train/rgb.py `_rebudget` in its coupled form: the
    port's chunked layout has one budget). Silently truncating it
    collapses training."""
    new_mi = (int(max(slots, ninst, raster_cfg.max_instances) * 1.5)
              + BUDGET_QUANTUM - 1) // BUDGET_QUANTUM * BUDGET_QUANTUM
    print(f"[goi_tpu_torch] instance budget overflow (demand "
          f"{max(slots, ninst)}/{raster_cfg.max_instances}); rebudgeting "
          f"to {new_mi}")
    return dataclasses.replace(raster_cfg, max_instances=new_mi)


def train_distillation(
    scene: GaussianScene,
    cameras,                      # list[Camera]
    feature_maps,                 # list of (C, H, W) arrays or tensors
    *,
    tab_len: int = 300,
    iterations: int = 1500,
    cfg: Optional[OptimConfig] = None,
    raster_cfg: Optional[RasterConfig] = None,
    white_background: bool = False,
    seed: int = 0,
    log_every: int = 100,
    callback=None,
    tb_log_dir: Optional[str] = None,
    spatial_lr_scale: float = 1.0,
) -> DistillState:
    """Host-side training loop (ref:train.py:96-202): random camera
    order per epoch from np.random.default_rng(seed), each camera's
    feature map moved to the scene's device at its step, periodic
    logging, and a rebudget whenever the logged step overflowed its
    instance budget. With `tb_log_dir`, the total loss and the step
    time (utils/profiling.py's StepTimer) go to TensorBoard every 10
    steps (ref:train.py:230-233).
    The k-means init and the decoder draw from one torch.Generator
    seeded with `seed`."""
    cfg = cfg or OptimConfig(iterations=iterations)
    raster_cfg = raster_cfg or RasterConfig()
    dev = scene.device
    gen = torch.Generator().manual_seed(seed)

    t0 = time.time()
    lut = init_codebook(gen, feature_maps, tab_len=tab_len, device=dev)
    print(f"Kmeans time: {time.time() - t0:.2f}s")
    decoder = SemanticDecoder.create(gen, dim_in=scene.sem_dim,
                                     dim_out=tab_len, num_layer=1,
                                     use_bias=True, device=dev)
    state, train_step = create_distill_state(
        scene, decoder, lut, cfg, spatial_lr_scale=spatial_lr_scale)

    bg = torch.ones(3, device=dev) if white_background \
        else torch.zeros(3, device=dev)
    rng = np.random.default_rng(seed)
    stack: list = []
    tb = TensorBoardLogger(tb_log_dir) if tb_log_dir else None
    timer = StepTimer()
    for it in range(1, iterations + 1):
        if not stack:
            stack = list(rng.permutation(len(cameras)))
        ci = int(stack.pop())
        gt = torch.as_tensor(feature_maps[ci], dtype=torch.float32,
                             device=dev)
        with timer:
            state, aux = train_step(state, cameras[ci], gt, bg, raster_cfg)
        if tb is not None and it % 10 == 0:
            tb.scalar("train_loss_patches/total_loss", float(aux["total"]),
                      it)
            tb.scalar("iter_time", timer.ms, it)
        if it % log_every == 1 or it == iterations:
            slots = int(aux["num_slots"])
            ninst = int(aux["num_instances"])
            if slots > raster_cfg.max_instances \
                    or ninst > raster_cfg.max_instances:
                raster_cfg = _rebudget(raster_cfg, slots, ninst)
            print(f"iter {it}, sem_loss: {float(aux['total']):.6f} "
                  f"(lab {float(aux['lab']):.4f} sl {float(aux['sl']):.4f} "
                  f"sl1 {float(aux['sl1']):.4f} "
                  f"recc {float(aux['recc']):.4f})")
        if callback is not None:
            callback(it, state, aux)
    if tb is not None:
        tb.close()
    return state
