"""Semantic-field distillation training: `python -m goi_tpu_torch.train`.

Counterpart of the root train.py (ref:train.py:271-301), with its flags
plus `--device`: loads the pre-trained 3DGS scene (iteration 1 by
convention), the offline APE feature maps of the train cameras,
k-means-initialises the codebook from them, runs the 4-term
distillation for --iterations steps, reports the PSNR of the eval split
at --test_iterations and saves the PLY + decoder + LUT triplet at
--save_iterations and the last iteration.

  python -m goi_tpu_torch.train -s <scene_dir> -m <model_dir> \\
      [--iterations 1500] [--device cuda|cpu]
"""

from __future__ import annotations

import dataclasses
import os
import time
from argparse import ArgumentParser

import numpy as np
import torch

from goi_tpu_torch import _cli
from goi_tpu_torch.configs.params import (ModelParams, PipelineParams,
                                          add_params, extract_params,
                                          save_params)
from goi_tpu_torch.train.optim import OptimConfig


def parse_args(argv=None):
    parser = ArgumentParser(description="goi_tpu_torch distillation "
                                        "training")
    add_params(parser, ModelParams, "Loading Parameters")
    add_params(parser, OptimConfig, "Optimization Parameters")
    add_params(parser, PipelineParams, "Pipeline Parameters")
    # the viewer's address (the reference's flags; no viewer connects
    # to the port's trainer yet)
    parser.add_argument("--ip", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=12652)
    parser.add_argument("--test_iterations", nargs="+", type=int,
                        default=[1000, 1500])
    parser.add_argument("--save_iterations", nargs="+", type=int,
                        default=[1000, 1500])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--max_instances", type=int, default=0,
                        help="0 = auto-size from the scene")
    parser.add_argument("--quiet", action="store_true")
    _cli.add_device_flag(parser)
    return parser.parse_args(argv)


def validation_report(it, state, scene, mp, raster_cfg, bg):
    """Mean PSNR over the eval split and the first 5 train views
    (ref:train.py:228-268 training_report); returns {split: PSNR}."""
    from goi_tpu_torch.data.dataset import load_image
    from goi_tpu_torch.eval.metrics import psnr
    from goi_tpu_torch.raster.render import render

    dev = bg.device
    report = {}
    for split, cams, infos in (
            ("test", scene.test_cameras, scene.info.test_cameras),
            ("train", scene.train_cameras[:5], scene.info.train_cameras[:5])):
        if not cams:
            continue
        vals = []
        with torch.no_grad():
            for cam, info in zip(cams, infos):
                out = render(state.scene, cam, bg, raster_cfg)
                gt = torch.as_tensor(load_image(info, mp.resolution),
                                     device=dev)
                vals.append(float(psnr(torch.clamp(out["render"], 0, 1),
                                       gt)))
        report[split] = float(np.mean(vals))
        print(f"\n[ITER {it}] Evaluating {split}: PSNR "
              f"{report[split]:.4f}")
    return report


def main(argv=None):
    args = parse_args(argv)
    device = _cli.resolve_device(args.device)
    mp = extract_params(args, ModelParams)
    op = extract_params(args, OptimConfig)
    if not mp.model_path:
        mp = dataclasses.replace(mp, model_path=os.path.join("./output",
                                                             "run"))
    save_params(mp.model_path, mp, op)

    from goi_tpu_torch.data.dataset import load_feature_map
    from goi_tpu_torch.data.scene import Scene
    from goi_tpu_torch.raster.render import RasterConfig, suggest_budgets
    from goi_tpu_torch.train.distill import train_distillation

    clock = _cli.Clock(device)
    with clock.phase("load"):
        scene = Scene(mp, load_iteration=1, device=device)
        feats = []
        for info in scene.info.train_cameras:
            fm = load_feature_map(info.semantic_path)
            if fm is None:
                raise FileNotFoundError(
                    f"missing APE feature map {info.semantic_path}; run the "
                    "offline feature extraction first (reference README)")
            feats.append(fm)
    cams = scene.train_cameras
    if args.max_instances > 0:
        budget = args.max_instances
    else:
        budget, _ = suggest_budgets(scene.gaussians, cams[:8])
        print(f"instance budget: {budget}")
    raster_cfg = RasterConfig(max_instances=budget)
    bg = torch.ones(3, device=device) if mp.white_background \
        else torch.zeros(3, device=device)

    tests = set(args.test_iterations)
    saves = set(args.save_iterations) | {op.iterations}
    psnrs = {}
    step_s = []        # from one callback's end to the next one's start
    last_end = None

    def checkpoint_cb(it, state, aux):
        nonlocal last_end
        if last_end is not None:
            step_s.append(time.perf_counter() - last_end)
        if it in tests:
            psnrs[it] = validation_report(it, state, scene, mp, raster_cfg,
                                          bg)
        if it in saves:
            with clock.phase("save"):
                scene.gaussians = state.scene
                out = scene.save(it, decoder=state.decoder, lut=state.lut)
            print(f"[ITER {it}] Saved to {out}")
        last_end = time.perf_counter()

    with clock.phase("compute"):
        state = train_distillation(
            scene.gaussians, cams, feats, tab_len=mp.tab_len,
            iterations=op.iterations, cfg=op, raster_cfg=raster_cfg,
            white_background=mp.white_background, seed=args.seed,
            callback=checkpoint_cb, tb_log_dir=mp.model_path,
            spatial_lr_scale=scene.cameras_extent)
    # the saves ran inside the training loop's callback
    clock.seconds["compute"] -= clock.seconds.get("save", 0.0)
    print("\nTraining complete.")
    _cli.summary("train", clock, iterations=op.iterations,
                 step_ms_p50=(float(np.median(step_s)) * 1e3
                              if step_s else None),
                 psnr=psnrs, budget=budget)
    return state


if __name__ == "__main__":
    main()
