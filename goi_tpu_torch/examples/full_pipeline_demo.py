"""End-to-end GOI pipeline on synthetic data, on the port.

The port of the JAX package's examples/full_pipeline_demo.py, with the
same stages, sizes and schedule (the reference's workflow, SURVEY.md
§3.1-§3.3, with no external dataset or frozen-model weights):

  1. build a ground-truth scene of coloured object clusters,
  2. render a multi-view RGB dataset and pixel-aligned 'APE' feature
     maps (each object carries its own feature vector, the stand-in for
     offline APE/CLIP extraction),
  3. train a fresh 3DGS scene from a noisy point cloud (densification
     on) -> held-out PSNR,
  4. distil the semantic field through the codebook,
  5. open-vocabulary query by a 'text' embedding -> masks -> mIoU, mPA,
     mP,
  6. OSH hyperplane fine-tune against a RES-style mask -> IoU.

  python -m goi_tpu_torch.examples.full_pipeline_demo [--fast]
      [--device cuda|cpu]

It runs on the CUDA card unless given `--device cpu`, and stops where it
is asked for a card and finds none. Besides the JAX script's lines it
prints one summary line, `[goi_tpu_torch.examples.full_pipeline_demo]
{json}`: the seconds of each stage, the results and each kernel's
launches.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

N_OBJECTS = 5


def build_gt_scene(n_objects=N_OBJECTS, pts_per_obj=3000, seed=0,
                   device="cuda"):
    """Clusters of Gaussians, one colour per object; opacity ~0.85,
    semantics the object's one-hot channel (x4)."""
    from goi_tpu_torch.core.scene import GaussianScene

    rng = np.random.default_rng(seed)
    centers = rng.uniform(-1.2, 1.2, (n_objects, 3))
    centers[:, 1] *= 0.4
    palette = rng.uniform(0.2, 1.0, (n_objects, 3))
    xyz, colors, obj_ids = [], [], []
    for k in range(n_objects):
        xyz.append(centers[k] + rng.normal(0, 0.22, (pts_per_obj, 3)))
        colors.append(np.tile(palette[k], (pts_per_obj, 1))
                      * rng.uniform(0.7, 1.0, (pts_per_obj, 1)))
        obj_ids.append(np.full(pts_per_obj, k))
    xyz = np.concatenate(xyz).astype(np.float32)
    colors = np.concatenate(colors).astype(np.float32)
    obj_ids = np.concatenate(obj_ids)

    scene = GaussianScene.create(
        xyz, colors, sh_degree=3, sem_dim=10,
        scales=np.full(len(xyz), 0.035, np.float32), device=device)
    sems = np.zeros((len(xyz), 10), np.float32)
    sems[np.arange(len(xyz)), obj_ids] = 4.0
    scene = scene.replace(
        active_sh_degree=0,
        opacity=torch.full_like(scene.opacity, 1.8),
        semantics=torch.as_tensor(sems, device=device))
    return scene, obj_ids, palette


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true",
                    help="the smoke-test configuration")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from goi_tpu_torch import _cli
    from goi_tpu_torch.app.session import QuerySession
    from goi_tpu_torch.core.camera import Camera
    from goi_tpu_torch.core.scene import GaussianScene
    from goi_tpu_torch.eval.metrics import psnr
    from goi_tpu_torch.raster.render import (RasterConfig, render,
                                             suggest_budgets)
    from goi_tpu_torch.train.distill import train_distillation
    from goi_tpu_torch.train.optim import OptimConfig
    from goi_tpu_torch.train.rgb import train_rgb

    device = _cli.resolve_device(args.device)
    clock = _cli.Clock(device)
    W, H = (256, 192) if args.fast else (512, 384)
    n_views = 8 if args.fast else 24
    rgb_iters = 300 if args.fast else 3000
    distill_iters = 120 if args.fast else 1500
    ape_dim, tab_len = 64, 32

    t_start = time.time()
    with clock.phase("dataset"):
        gt_scene, _, _ = build_gt_scene(device=device)
        cams = [Camera.look_at(
            [3.2 * np.sin(a), 1.2, -3.2 * np.cos(a)], [0, 0, 0], [0, 1, 0],
            fovx=0.9, fovy=0.72, width=W, height=H, device=device)
            for a in np.linspace(0, 2 * np.pi, n_views, endpoint=False)]
        test_cams = cams[::8]
        train_idx = [i for i in range(n_views) if i % 8 != 0]

        budget, _ = suggest_budgets(gt_scene, cams[:4])
        cfg = RasterConfig(max_instances=budget)
        bg = torch.zeros(3, device=device)

        # ---- 2. dataset: RGB + APE feature maps + GT object masks ----
        rng = np.random.default_rng(1)
        # Simplex-separated unit features (pairwise dot exactly
        # -1/(n-1)): non-matching pixel/text dots must be negative, as in
        # the aligned space, since the reference's decision rule
        # sigmoid(dot*scale + 2) > 0.86 fires for any dot > -0.015
        # (ref:ext/vision_language_align.py:109-122,
        # gui/main.py:378-380)
        q, _ = np.linalg.qr(rng.normal(0, 1, (ape_dim, 6)))
        basis = q.T.astype(np.float32)                    # 6 orthonormal
        obj_feats = basis - basis.mean(0, keepdims=True)
        obj_feats /= np.linalg.norm(obj_feats, axis=1, keepdims=True)
        feats_t = torch.as_tensor(obj_feats, device=device)
        images, ape_maps, gt_masks = [], [], []
        for c in cams:
            with torch.no_grad():
                out = render(gt_scene, c, bg, cfg)
            images.append(out["render"])
            wmap = out["semantics"][:N_OBJECTS]            # (5, H, W)
            ape = torch.einsum("ohw,oc->chw", wmap, feats_t[:N_OBJECTS])
            bg_w = torch.clamp(1.0 - wmap.sum(0), min=0.0)
            ape_maps.append(ape + bg_w[None] * feats_t[5][:, None, None])
            gt_masks.append(torch.where(
                wmap.max(0).values > 0.2, wmap.argmax(0),
                torch.full_like(wmap[0], -1, dtype=torch.int64))
                .cpu().numpy())
    print(f"[{time.time()-t_start:6.1f}s] dataset: {n_views} views "
          f"{W}x{H}, gt scene {int(gt_scene.num_valid)} gaussians",
          flush=True)

    # ---- 3. RGB training from a noisy point cloud ----
    with clock.phase("rgb"):
        gt_xyz = gt_scene.xyz.cpu().numpy()[::4]
        pcd = gt_xyz + rng.normal(0, 0.02, gt_xyz.shape).astype(np.float32)
        start = GaussianScene.create(
            pcd, None, sh_degree=3, sem_dim=10,
            scales=np.full(len(pcd), 0.05, np.float32),
            capacity=int(len(pcd) * 4), device=device)
        # the JAX package's quality sweep schedule (its examples/
        # tune_rgb.py, tag E1_sched): the position lr decays over the
        # whole run and densification outlives the last opacity reset
        ocfg = OptimConfig(
            iterations=rgb_iters, densify_from_iter=200,
            densify_until_iter=int(rgb_iters * 0.65),
            densification_interval=150,
            opacity_reset_interval=3000,
            position_lr_max_steps=rgb_iters,
            densify_grad_threshold=0.0004)
        state, cfg = train_rgb(
            start, [cams[i] for i in train_idx],
            [images[i] for i in train_idx],
            cfg=ocfg, raster_cfg=cfg, iterations=rgb_iters,
            scene_extent=3.5, log_every=max(rgb_iters // 4, 1),
            return_raster_cfg=True)
        trained = state.scene.with_params(
            {k: v.detach() for k, v in state.scene.params().items()})
        with torch.no_grad():
            ps = [float(psnr(render(trained, c, bg, cfg)["render"],
                             images[i * 8]))
                  for i, c in enumerate(test_cams)]
    print(f"[{time.time()-t_start:6.1f}s] RGB training: "
          f"{int(trained.num_valid)} gaussians, held-out PSNR "
          f"{np.mean(ps):.2f} dB", flush=True)

    # ---- 4. semantic distillation ----
    with clock.phase("distill"):
        fresh = trained.replace(semantics=torch.zeros_like(
            trained.semantics))
        dstate = train_distillation(
            fresh, [cams[i] for i in train_idx],
            [ape_maps[i] for i in train_idx],
            tab_len=tab_len, iterations=distill_iters,
            raster_cfg=cfg, log_every=max(distill_iters // 3, 1))
    print(f"[{time.time()-t_start:6.1f}s] distillation done", flush=True)

    # ---- 5. open-vocab query -> segmentation metrics ----
    with clock.phase("query"):
        sess = QuerySession(dstate.scene, dstate.decoder, dstate.lut, cfg,
                            sim_thresh=0.86, white_background=False,
                            device=device)
        per_obj = []
        for k in range(N_OBJECTS):
            sess.set_text(obj_feats[k] * 12.0)
            m = sess.eval_against_gt(
                test_cams, [gt_masks[i * 8] == k
                            for i in range(len(test_cams))])
            per_obj.append([m["iou"], m["mpa"], m["mp"]])
        per_obj = np.asarray(per_obj)
    print(f"[{time.time()-t_start:6.1f}s] query eval over {N_OBJECTS} "
          f"objects: mIoU {per_obj[:,0].mean():.3f} mPA "
          f"{per_obj[:,1].mean():.3f} mP {per_obj[:,2].mean():.3f}",
          flush=True)

    # ---- 6. OSH fine-tune on the worst object ----
    # (with --fast the one test view, cams[0], shows no pixel of object
    # 4: it scores IoU 0 (its mP is 0/0), is picked, and its RES mask is
    # empty, so the fine-tune runs its 2000 epochs at IoU 0, the JAX
    # script's rule and outcome)
    with clock.phase("osh"):
        worst = int(np.argmin(per_obj[:, 0]))
        sess.set_text(obj_feats[worst] * 12.0)
        # the view where the object is most visible
        vis = [int((gt_masks[i * 8] == worst).sum())
               for i in range(len(test_cams))]
        vi = int(np.argmax(vis))
        res_mask = (gt_masks[vi * 8] == worst).astype(np.float32)
        iou, epochs = sess.finetune_with_res(test_cams[vi], res_mask,
                                             max_epochs=2000)
    print(f"[{time.time()-t_start:6.1f}s] OSH finetune obj {worst}: "
          f"IoU {per_obj[worst,0]:.3f} -> {iou:.3f} "
          f"({epochs} epochs)", flush=True)

    result = dict(psnr=float(np.mean(ps)), miou=float(per_obj[:, 0].mean()),
                  osh_iou=float(iou))
    _cli.summary("examples.full_pipeline_demo", clock, osh_epochs=epochs,
                 n_gaussians=int(trained.num_valid),
                 budget=cfg.max_instances, **result)
    print("PIPELINE COMPLETE", flush=True)
    return result


if __name__ == "__main__":
    main()
