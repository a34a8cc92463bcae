"""SDS scene-editing loop (the reference's main_edit.py train path).

Counterpart of goi_tpu/app/edit.py. Headless: precompute the relative
cameras and the frozen-Gaussian mask (ref:gui/main_edit.py:312-395),
then batched SDS steps: render each camera -> inpainting SDS loss on the
dilated masks -> backward -> zero the gradients of non-target Gaussians
-> Adam (ref:gui/main_edit.py:506-720, clear_noralative_gs_grad
:396-432). A step is an eager sequence of launches on the scene's
device: the render's kernels, the VAE encode, the UNet's classifier-free
pair, then the backward through the encode and the resize into the
render's backward kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from goi_tpu_torch.core.camera import Camera
from goi_tpu_torch.core.scene import GaussianScene
from goi_tpu_torch.guidance.sds import InpaintSDS, dilate_mask
from goi_tpu_torch.raster.render import RasterConfig, render
from goi_tpu_torch.train.optim import (OptimConfig,
                                       make_full_training_optimizer,
                                       set_scheduled_lr)


@dataclasses.dataclass
class RelativeCamera:
    camera: Camera
    mask: torch.Tensor            # dilated edit mask (H, W) bool
    mask_nodilated: torch.Tensor


class EditSession:
    def __init__(self, scene: GaussianScene, guidance: InpaintSDS,
                 raster_cfg: RasterConfig = RasterConfig(),
                 cfg: Optional[OptimConfig] = None,
                 lambda_sd: float = 10.0,
                 guidance_scale: float = 100.0,
                 max_epochs: int = 40, batch_size: int = 2):
        """Defaults from ref:gui/configs/default.yaml:26-31. The Adam
        state lives in the session across `train` calls, bound to the
        parameters of whatever scene the session holds when one starts."""
        self.scene = scene
        self.guidance = guidance
        self.raster_cfg = raster_cfg
        self.lambda_sd = lambda_sd
        self.guidance_scale = guidance_scale
        self.max_epochs = max_epochs
        self.batch_size = batch_size
        self.opt = make_full_training_optimizer(
            cfg or OptimConfig(), 1.0, self._leaves())
        self.steps = 0                  # Adam steps taken, for the schedule
        self.grad_mask: Optional[torch.Tensor] = None
        self.relative_cameras: List[RelativeCamera] = []

    def _leaves(self) -> dict:
        """Fresh leaves holding the session scene's parameters."""
        return {k: v.detach().clone().requires_grad_()
                for k, v in self.scene.params().items()}

    @torch.no_grad()
    def precompute(self, cameras: List[Camera], similarity_fn: Callable,
                   min_relative_ratio: float = 0.1) -> int:
        """Select cameras seeing the edit target; build dilated masks and
        the frozen-Gaussian mask (ref:gui/main_edit.py:312-395)."""
        dev = self.scene.device
        self.grad_mask = (similarity_fn(self.scene.get_semantics())
                          > 0).to(torch.float32)
        bg = torch.ones(3, device=dev)
        counts, masks = [], []
        for cam in cameras:
            out = render(self.scene, cam.to(dev), bg, self.raster_cfg)
            s = out["semantics"].shape[0]
            sim = similarity_fn(out["semantics"].reshape(s, -1).T)
            m = (sim > 0).reshape(cam.height, cam.width)
            counts.append(int(m.sum()))
            masks.append(m)
        max_count = max(counts) if counts else 0
        self.relative_cameras = []
        for cam, m, c in zip(cameras, masks, counts):
            if max_count == 0 or c < min_relative_ratio * max_count:
                continue
            self.relative_cameras.append(RelativeCamera(
                camera=cam.to(dev), mask=dilate_mask(m), mask_nodilated=m))
        return len(self.relative_cameras)

    def _rebind(self, params: dict) -> None:
        """Point each Adam group at its new leaf, carrying its state."""
        for group in self.opt.param_groups:
            (old,) = group["params"]
            new = params[group["name"]]
            if old in self.opt.state:
                self.opt.state[new] = self.opt.state.pop(old)
            group["params"] = [new]

    def step(self, params: dict, cams, masks: torch.Tensor,
             generator: torch.Generator, step_ratio: float) -> torch.Tensor:
        """One SDS step over a batch of cameras; updates `params` (the
        leaves the optimizer holds) in place and returns the loss."""
        for p in params.values():
            p.grad = None
        scene = self.scene.with_params(params)
        bg = torch.ones(3, device=scene.device)
        imgs = torch.stack([render(scene, c, bg, self.raster_cfg)["render"]
                            for c in cams])
        loss = self.guidance.train_step(
            generator, imgs, masks, step_ratio=step_ratio,
            guidance_scale=self.guidance_scale) * self.lambda_sd
        loss.backward()
        # zero grads outside the edit target (ref:gui/main_edit.py:668-670
        # -> :396-432); an attribute the render did not read gets a zero
        # gradient, so that every Adam count advances as optax's do
        for p in params.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            p.grad.mul_(self.grad_mask.reshape((-1,) + (1,) * (p.dim() - 1)))
        set_scheduled_lr(self.opt, self.steps)
        self.opt.step()
        self.steps += 1
        return loss.detach()

    def train(self, generator: Optional[torch.Generator] = None,
              epochs: Optional[int] = None, log_every: int = 5):
        """(ref:gui/main_edit.py:481-504 train/train_epoch). The camera
        order of each epoch is np.random.default_rng(0)'s permutation;
        the noise comes from `generator` (seed 0 on the scene's device
        when none is given)."""
        if not self.relative_cameras:
            raise ValueError("call precompute() first")
        dev = self.scene.device
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        epochs = epochs or self.max_epochs
        params = self._leaves()
        self._rebind(params)
        rng = np.random.default_rng(0)
        n = len(self.relative_cameras)
        total_steps = epochs * max(1, n // self.batch_size)
        it = 0
        loss = None
        for ep in range(epochs):
            order = rng.permutation(n)
            for i in range(0, n - self.batch_size + 1, self.batch_size):
                batch = [self.relative_cameras[j]
                         for j in order[i:i + self.batch_size]]
                masks = torch.stack([b.mask[None] for b in batch]).to(
                    torch.float32)
                it += 1
                loss = self.step(params, [b.camera for b in batch], masks,
                                 generator, it / total_steps)
            if (ep + 1) % log_every == 0 and loss is not None:
                print(f"edit epoch {ep + 1}/{epochs} "
                      f"loss {float(loss):.5f}")
        self.scene = self.scene.with_params(
            {k: v.detach() for k, v in params.items()})
        return self.scene
