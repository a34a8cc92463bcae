"""Training checkpoint save and restore.

Counterpart of goi_tpu/train/checkpoint.py, the role of the reference's
full checkpoint (gaussians.capture() -> chkpnt<N>.pth, restored with
the optimizer state; ref:train.py:71-73, 200-202,
scene/gaussian_model.py:54-88). A state (DistillState or RGBTrainState)
is written with `torch.save` as a plain dict of tensors and numbers:
the scene's tensors, `valid` and SH degrees, the decoder, the LUT, each
optimizer's `state_dict()`, the densify stats and the step. Loading
rebuilds the dataclasses, so `torch.load(..., weights_only=True)`
reads it. The PLY + decoder + LUT triplet (data/scene.py) stays the
interchange format between the packages; a JAX checkpoint does not
load here.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Union

import torch

from goi_tpu_torch.core.scene import GaussianScene
from goi_tpu_torch.semantic.codebook import SemanticDecoder
from goi_tpu_torch.train.densify import DensifyStats
from goi_tpu_torch.train.distill import DistillState
from goi_tpu_torch.train.optim import ExponLR
from goi_tpu_torch.train.rgb import RGBTrainState

State = Union[DistillState, RGBTrainState]


def _opt_dict(opt):
    """An optimizer's state_dict with its lr schedules as their fields."""
    if opt is None:
        return None
    sd = opt.state_dict()
    sd["param_groups"] = [
        dict(g, schedule=dataclasses.asdict(g["schedule"]))
        if "schedule" in g else g for g in sd["param_groups"]]
    return sd


def _scene_dict(scene: GaussianScene) -> dict:
    out = {k: getattr(scene, k).detach()
           for k in GaussianScene.PARAM_FIELDS + ("valid",)}
    out.update(active_sh_degree=scene.active_sh_degree,
               max_sh_degree=scene.max_sh_degree)
    return out


def save_checkpoint(path: str, state: State) -> str:
    """Write `state` to the file `path` (overwritten); returns path."""
    if not isinstance(state, (RGBTrainState, DistillState)):
        raise TypeError(f"no checkpoint format for {type(state).__name__}")
    payload = {"scene": _scene_dict(state.scene), "step": int(state.step)}
    if isinstance(state, RGBTrainState):
        payload.update(
            kind="rgb", opt=_opt_dict(state.opt),
            stats={f.name: getattr(state.stats, f.name)
                   for f in dataclasses.fields(state.stats)})
    else:
        payload.update(
            kind="distill",
            decoder={"weights": [w.detach() for w in state.decoder.weights],
                     "biases": [None if b is None else b.detach()
                                for b in state.decoder.biases],
                     "norm_output": state.decoder.norm_output},
            lut=state.lut.detach(), opt_scene=_opt_dict(state.opt_scene),
            opt_decoder=_opt_dict(state.opt_decoder),
            opt_lut=_opt_dict(state.opt_lut))
    torch.save(payload, path)
    return path


def _adam(sd, groups: Iterable[List[torch.Tensor]]) -> torch.optim.Adam:
    """A torch Adam over `groups` (one parameter list per saved group, in
    its order) with the saved state: moments, step counts, schedules."""
    saved = [dict(g, schedule=ExponLR(**g["schedule"])) if "schedule" in g
             else g for g in sd["param_groups"]]
    opt = torch.optim.Adam(
        [dict(g, params=ps) for g, ps in zip(saved, groups)])
    opt.load_state_dict(dict(sd, param_groups=saved))
    return opt


def load_checkpoint(path: str, device="cuda") -> State:
    """The state that save_checkpoint wrote, its tensors on `device`.
    The trained parameters are leaves that require grad, held by the
    rebuilt optimizers (their step counts stay on the host, as torch
    Adam keeps them)."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    sc = blob["scene"]
    trained = set()
    for key in ("opt", "opt_scene"):
        if blob.get(key) is not None:
            trained |= {g["name"] for g in blob[key]["param_groups"]}
    scene = GaussianScene(
        **{k: (sc[k].to(device).requires_grad_(k in trained)
               if k != "valid" else sc[k].to(device))
           for k in GaussianScene.PARAM_FIELDS + ("valid",)},
        active_sh_degree=sc["active_sh_degree"],
        max_sh_degree=sc["max_sh_degree"])

    def scene_groups(sd):
        return [[getattr(scene, g["name"])] for g in sd["param_groups"]]

    if blob["kind"] == "rgb":
        return RGBTrainState(
            scene=scene, opt=_adam(blob["opt"], scene_groups(blob["opt"])),
            stats=DensifyStats(**{k: v.to(device)
                                  for k, v in blob["stats"].items()}),
            step=blob["step"])
    dec = blob["decoder"]
    decoder = SemanticDecoder(
        [w.to(device) for w in dec["weights"]],
        [None if b is None else b.to(device) for b in dec["biases"]],
        norm_output=dec["norm_output"])
    lut = blob["lut"].to(device).requires_grad_()
    return DistillState(
        scene=scene, decoder=decoder, lut=lut,
        opt_scene=(None if blob["opt_scene"] is None else
                   _adam(blob["opt_scene"], scene_groups(blob["opt_scene"]))),
        opt_decoder=_adam(blob["opt_decoder"], [list(decoder.parameters())]),
        opt_lut=_adam(blob["opt_lut"], [[lut]]),
        step=blob["step"])
