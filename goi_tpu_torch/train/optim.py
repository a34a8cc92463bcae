"""Per-attribute optimizers for the Gaussian scene.

Counterpart of goi_tpu/train/optim.py, with reference semantics
(ref:scene/gaussian_model.py:163-244, train.py:63-67): Adam (eps=1e-15)
with a parameter group per attribute, an exponential log-lerp schedule
on xyz, and per-attribute finetune toggles (GOI's semantic distillation
trains only `semantics` by default, ref:arguments/__init__.py:85-90).
Where the JAX package zeroes the update of an attribute whose flag is
off, the port leaves it out of the optimizer and out of autograd.
`make_full_training_optimizer` turns every attribute on, for RGB
training (train/rgb.py).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """OptimizationParams (ref:arguments/__init__.py:64-91), with the JAX
    package's names and defaults. Distillation reads `iterations`, the
    learning rates and the finetune toggles; RGB training (train/rgb.py)
    reads the densification and RGB-loss fields as well, with every
    toggle on."""

    iterations: int = 1500
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    semantic_lr: float = 0.005
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15000
    densify_grad_threshold: float = 0.0002
    # finetune toggles (GOI defaults: only semantics)
    position_finetune: bool = False
    feature_finetune: bool = False
    opacity_finetune: bool = False
    scaling_finetune: bool = False
    rotation_finetune: bool = False
    semantic_finetune: bool = True


@dataclasses.dataclass(frozen=True)
class ExponLR:
    """Log-linear interpolation with optional delayed warmup, matching
    get_expon_lr_func (ref:utils/general_utils.py:98-121). A plain
    dataclass, so that an optimizer's param group that holds one can be
    written to a checkpoint (train/checkpoint.py) as its fields."""

    lr_init: float
    lr_final: float
    max_steps: int
    lr_delay_steps: int = 0
    lr_delay_mult: float = 1.0

    def __call__(self, step: int) -> float:
        if self.lr_init == 0.0 and self.lr_final == 0.0:
            return 0.0
        if self.lr_delay_steps > 0:
            delay_rate = self.lr_delay_mult + (
                1 - self.lr_delay_mult) * math.sin(0.5 * math.pi * min(
                    max(step / self.lr_delay_steps, 0.0), 1.0))
        else:
            delay_rate = 1.0
        t = min(max(step / self.max_steps, 0.0), 1.0)
        return delay_rate * math.exp(math.log(self.lr_init) * (1 - t)
                                     + math.log(self.lr_final) * t)


def expon_lr_schedule(lr_init, lr_final, max_steps, lr_delay_steps=0,
                      lr_delay_mult=1.0) -> Callable[[int], float]:
    """The xyz schedule (ref:utils/general_utils.py:98-121)."""
    return ExponLR(lr_init, lr_final, max_steps, lr_delay_steps,
                   lr_delay_mult)


def scene_learning_rates(cfg: OptimConfig, spatial_lr_scale: float) -> dict:
    """{attribute: learning rate or schedule} of the finetuned
    attributes, in the reference's param-group order."""
    lrs = {
        "xyz": (cfg.position_finetune, expon_lr_schedule(
            cfg.position_lr_init * spatial_lr_scale,
            cfg.position_lr_final * spatial_lr_scale,
            cfg.position_lr_max_steps,
            lr_delay_mult=cfg.position_lr_delay_mult)),
        "features_dc": (cfg.feature_finetune, cfg.feature_lr),
        "features_rest": (cfg.feature_finetune, cfg.feature_lr / 20.0),
        "semantics": (cfg.semantic_finetune, cfg.semantic_lr),
        "opacity": (cfg.opacity_finetune, cfg.opacity_lr),
        "scaling": (cfg.scaling_finetune, cfg.scaling_lr),
        "rotation": (cfg.rotation_finetune, cfg.rotation_lr),
    }
    return {k: lr for k, (on, lr) in lrs.items() if on}


def make_scene_optimizer(cfg: OptimConfig, spatial_lr_scale: float,
                         params: dict) -> Optional[torch.optim.Adam]:
    """Adam (b1 0.9, b2 0.999, eps 1e-15) with one group per finetuned
    attribute of `params` (GaussianScene.params()); None when no
    attribute is finetuned. A group whose learning rate is a schedule
    keeps it under "schedule": `set_scheduled_lr` evaluates it at the
    step count before each step, as optax's scale_by_schedule does."""
    groups = []
    for name, lr in scene_learning_rates(cfg, spatial_lr_scale).items():
        group = {"params": [params[name]], "name": name}
        if callable(lr):
            group.update(lr=lr(0), schedule=lr)
        else:
            group["lr"] = lr
        groups.append(group)
    if not groups:
        return None
    return torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-15)


def make_full_training_optimizer(cfg: OptimConfig, spatial_lr_scale: float,
                                 params: dict) -> torch.optim.Adam:
    """All-attribute optimizer for from-scratch RGB training
    (training_setup, ref:scene/gaussian_model.py:163-182): every
    finetune toggle on, the xyz schedule scaled by spatial_lr_scale."""
    full = dataclasses.replace(
        cfg, position_finetune=True, feature_finetune=True,
        opacity_finetune=True, scaling_finetune=True,
        rotation_finetune=True, semantic_finetune=True)
    return make_scene_optimizer(full, spatial_lr_scale, params)


def set_scheduled_lr(opt: Optional[torch.optim.Optimizer],
                     step: int) -> None:
    if opt is None:
        return
    for group in opt.param_groups:
        if "schedule" in group:
            group["lr"] = group["schedule"](step)
