"""Carry weights across from the JAX package.

Plain functions that take numpy arrays (a JAX object's leaves after
`np.asarray`) and build the port's objects on `device`, or load them
into an object of the port (an optax Adam state into a torch Adam).
They import nothing of the JAX package, so the port runs where JAX is
absent.

The frozen towers take flat params dicts keyed by the official
checkpoints' names, which are also the JAX package's keys: the JAX
``init_*_params``, a ``load_*_params`` of either package, or
``convert_openclip_text_state``'s output load through
`load_flat_params`, which holds the keys to the module's state_dict
exactly.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from goi_tpu_torch.core.camera import Camera
from goi_tpu_torch.core.scene import GaussianScene
from torch import nn

from goi_tpu_torch.query.align import VisionLanguageAlign
from goi_tpu_torch.query.clip_text import CLIPTextConfig, CLIPTextTransformer
from goi_tpu_torch.query.grounding import GroundingConfig, GroundingDINO
from goi_tpu_torch.query.osh import OSHState
from goi_tpu_torch.query.sam import SAM, SAMConfig
from goi_tpu_torch.semantic.codebook import SemanticDecoder


def _t(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a), device=device)


def scene_from_numpy(fields: Mapping[str, np.ndarray], *,
                     active_sh_degree: int, max_sh_degree: int,
                     device="cuda") -> GaussianScene:
    """fields: xyz, features_dc, features_rest, semantics, scaling,
    rotation, opacity (float32) and valid (bool), as GaussianScene's
    fields are named in both packages."""
    names = GaussianScene.PARAM_FIELDS + ("valid",)
    return GaussianScene(**{k: _t(fields[k], device) for k in names},
                         active_sh_degree=int(active_sh_degree),
                         max_sh_degree=int(max_sh_degree))


def camera_from_numpy(world_view, full_proj, camera_center, tan_fovx,
                      tan_fovy, width: int, height: int,
                      device="cuda") -> Camera:
    f32 = np.float32
    return Camera(world_view=_t(np.asarray(world_view, f32), device),
                  full_proj=_t(np.asarray(full_proj, f32), device),
                  camera_center=_t(np.asarray(camera_center, f32), device),
                  tan_fovx=_t(np.asarray(tan_fovx, f32), device),
                  tan_fovy=_t(np.asarray(tan_fovy, f32), device),
                  width=int(width), height=int(height))


def decoder_from_numpy(weights: Sequence[np.ndarray],
                       biases: Sequence[Optional[np.ndarray]],
                       norm_output: bool = False,
                       device="cuda") -> SemanticDecoder:
    return SemanticDecoder(
        [_t(np.asarray(w, np.float32), device) for w in weights],
        [None if b is None else _t(np.asarray(b, np.float32), device)
         for b in biases],
        norm_output=bool(norm_output))


def lut_from_numpy(lut: np.ndarray, device="cuda") -> torch.Tensor:
    return _t(np.asarray(lut, np.float32), device)


def osh_from_numpy(weight: np.ndarray, bias, device="cuda") -> OSHState:
    return OSHState(weight=_t(np.asarray(weight, np.float32), device),
                    bias=_t(np.asarray(bias, np.float32), device))


def aligner_from_numpy(w_text, b_text, log_scale, bias_lang, bias0,
                       device="cuda") -> VisionLanguageAlign:
    """A VisionLanguageAlign from the JAX aligner's five fields."""
    f32 = np.float32
    return VisionLanguageAlign(
        w_text=_t(np.asarray(w_text, f32), device),
        b_text=_t(np.asarray(b_text, f32), device),
        log_scale=_t(np.asarray(log_scale, f32).reshape(1), device),
        bias_lang=_t(np.asarray(bias_lang, f32), device),
        bias0=_t(np.asarray(bias0, f32).reshape(1), device))


def adam_state_from_numpy(opt: torch.optim.Adam,
                          groups: Mapping[str, Mapping]) -> None:
    """Load optax Adam states into `opt`, a torch Adam with one named
    parameter per group (train/optim.py's optimizers): groups maps a
    group's name to its optax `mu`, `nu` (arrays) and `count`, which
    become the parameter's `exp_avg`, `exp_avg_sq` and `step`."""
    by_name = {g["name"]: g["params"] for g in opt.param_groups}
    for name, st in groups.items():
        (p,) = by_name[name]
        opt.state[p] = {
            "step": torch.tensor(float(st["count"]), dtype=torch.float32),
            "exp_avg": _t(np.asarray(st["mu"], np.float32), p.device),
            "exp_avg_sq": _t(np.asarray(st["nu"], np.float32), p.device)}


def load_flat_params(module: nn.Module, params: Mapping) -> nn.Module:
    """Load a flat {state_dict key: array} dict into `module`: each array
    becomes a float32 tensor on the module's device, then
    ``load_state_dict(strict=True)`` (a missing or extra key raises)."""
    device = next(module.parameters()).device
    module.load_state_dict(
        {k: _t(np.asarray(v, np.float32), device) for k, v in params.items()},
        strict=True)
    return module


def clip_text_from_numpy(params: Mapping, cfg: CLIPTextConfig,
                         device="cuda") -> CLIPTextTransformer:
    """The text tower from `convert_openclip_text_state`'s (or the JAX
    init's) params."""
    return load_flat_params(CLIPTextTransformer(cfg, device=device),
                            params).eval()


def grounding_from_numpy(params: Mapping, cfg: GroundingConfig,
                         device="cuda") -> GroundingDINO:
    """GroundingDINO (Swin, BERT and the transformer in one dict, under
    the checkpoint's backbone.0. / bert. / transformer. names)."""
    return load_flat_params(GroundingDINO(cfg, device=device),
                            params).eval()


def sam_from_numpy(params: Mapping, cfg: SAMConfig, device="cuda") -> SAM:
    return load_flat_params(SAM(cfg, device=device), params).eval()
