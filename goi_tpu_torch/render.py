"""Offline render: `python -m goi_tpu_torch.render`.

Counterpart of the root render.py (the role of ref:render.py:13-55),
with its flags plus `--device`: the saved cfg_args of the run, merged
under the flags given, pick the scene; each split's views render to
`<model>/<split>/ours_<iter>/renders/` beside their ground truth in
`gt/`, as 8-bit PNGs named 00000.png, 00001.png, ...

  python -m goi_tpu_torch.render -m <model_dir> [--iteration N]
      [--skip_train] [--skip_test] [--device cuda|cpu]
"""

from __future__ import annotations

import os
from argparse import ArgumentParser

import torch

from goi_tpu_torch import _cli
from goi_tpu_torch.configs.params import (ModelParams, PipelineParams,
                                          add_params, combined_params)


def render_set(model_path, name, iteration, cameras, infos, gaussians,
               raster_cfg, bg, resolution, clock):
    from goi_tpu_torch.data.dataset import load_image
    from goi_tpu_torch.raster.render import render
    from goi_tpu_torch.utils.image import save_image

    base = os.path.join(model_path, name, f"ours_{iteration}")
    rdir = os.path.join(base, "renders")
    gdir = os.path.join(base, "gt")
    os.makedirs(rdir, exist_ok=True)
    os.makedirs(gdir, exist_ok=True)
    for idx, (cam, info) in enumerate(zip(cameras, infos)):
        with clock.phase("compute"), torch.no_grad():
            img = render(gaussians, cam, bg, raster_cfg)["render"]
        with clock.phase("io"):
            save_image(img, os.path.join(rdir, f"{idx:05d}.png"))
            save_image(load_image(info, resolution),
                       os.path.join(gdir, f"{idx:05d}.png"))
    return base


def main(argv=None):
    parser = ArgumentParser(description="goi_tpu_torch render")
    add_params(parser, ModelParams, "Loading Parameters")
    add_params(parser, PipelineParams, "Pipeline Parameters")
    parser.add_argument("--iteration", default=-1, type=int)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--max_instances", type=int, default=0,
                        help="0 = auto-size from the scene and its views "
                             "(the root CLI's fixed 2^20 truncates large "
                             "scenes)")
    _cli.add_device_flag(parser)
    args = parser.parse_args(argv)
    device = _cli.resolve_device(args.device)

    mp = combined_params(args, ModelParams)

    from goi_tpu_torch.data.scene import Scene
    from goi_tpu_torch.raster.render import RasterConfig, suggest_budgets

    clock = _cli.Clock(device)
    with clock.phase("load"):
        scene = Scene(mp, load_iteration=args.iteration, load_sem=False,
                      device=device)
    budget = args.max_instances
    if budget <= 0:
        budget, _ = suggest_budgets(
            scene.gaussians, scene.train_cameras + scene.test_cameras)
    raster_cfg = RasterConfig(max_instances=budget)
    bg = torch.ones(3, device=device) if mp.white_background \
        else torch.zeros(3, device=device)
    views = 0
    for split, cams, infos, skip in (
            ("train", scene.train_cameras, scene.info.train_cameras,
             args.skip_train),
            ("test", scene.test_cameras, scene.info.test_cameras,
             args.skip_test)):
        if skip or not cams:
            continue
        render_set(mp.model_path, split, scene.loaded_iter, cams, infos,
                   scene.gaussians, raster_cfg, bg, mp.resolution, clock)
        views += len(cams)
    _cli.summary("render", clock, iteration=scene.loaded_iter, views=views,
                 budget=budget)


if __name__ == "__main__":
    main()
