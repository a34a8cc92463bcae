"""The port's copy of tests/test_rgb_densify.py::test_rgb_psnr_bar, the
hard quality bar on the whole RGB stack (optimizer, render, schedule):
>= 25 dB after 700 steps on goi_tpu's sizes. Its own file, so that the
suite's workers run it beside the others."""

import numpy as np
import torch

from goi_tpu_torch.eval.metrics import psnr
from goi_tpu_torch.raster.render import RasterConfig, render
from goi_tpu_torch.train.optim import OptimConfig
from goi_tpu_torch.train.rgb import create_rgb_trainer
from tests.conftest import make_random_scene, make_test_camera
from tests.test_torch_core import to_torch_camera, to_torch_scene

torch.set_num_threads(1)

CFG = RasterConfig(max_instances=1 << 13)


def test_rgb_psnr_bar():
    target = to_torch_scene(make_random_scene(n=120, seed=7))
    cams = [to_torch_camera(make_test_camera(width=48, height=48, angle=a))
            for a in (0.0, 0.35)]
    bg = torch.zeros(3)
    with torch.no_grad():
        gts = [render(target, c, bg, CFG)["render"] for c in cams]

    start = to_torch_scene(make_random_scene(n=150, seed=21, capacity=200))
    ocfg = OptimConfig(
        position_lr_init=0.002, position_lr_final=0.0001,
        position_lr_max_steps=700,
        feature_lr=0.02, opacity_lr=0.05, scaling_lr=0.01,
        rotation_lr=0.005, lambda_dssim=0.2)
    init_fn, step_fn, _ = create_rgb_trainer(ocfg, CFG)
    state = init_fn(start)
    rng = np.random.default_rng(0)
    for _ in range(700):
        ci = int(rng.integers(0, len(cams)))
        state, _ = step_fn(state, cams[ci], gts[ci], bg)
    with torch.no_grad():
        vals = [float(psnr(render(state.scene, c, bg, CFG)["render"], g))
                for c, g in zip(cams, gts)]
    assert float(np.mean(vals)) >= 25.0, vals
