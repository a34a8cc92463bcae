"""One-command rehearsal of the port's workflow through its own CLIs.

Modelled on examples/round_rehearsal.py (--fast there), with the port's
modules and entry points only:

  1. synthesise a GT scene and an llffhold-8 camera ring; render the
     dataset with the port (images/ with seeded noise of sigma 0.02, so
     the PSNR of the GT scene's renders is finite; clip_feat/ APE maps
     as .npy; per-prompt GT masks) and write a COLMAP scene (sparse/0
     binaries);
  2. RGB pre-training (the reference trains RGB first and distils from
     iteration 1): a Scene created from the noisy SfM points, trained
     with train_rgb and saved as point_cloud/iteration_1;
  3. `python -m goi_tpu_torch.train`: distillation -> PLY + decoder +
     LUT triplet;
  4. `goi_tpu_torch.render` -> renders/ + gt/;
  5. `goi_tpu_torch.metrics` -> results.json / per_view.json;
  6. open-vocabulary query masks on the eval split through QuerySession,
     then `goi_tpu_torch.eval_seg` -> mIoU / mPA / mP;
  7. REHEARSAL.json: the artifact paths and the metrics.

Unlike the JAX script it has no gate on TPU perf artifacts.

  python -m goi_tpu_torch.examples.rehearsal --root <dir> [--fast]
      [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import struct

import numpy as np
import torch

N_OBJ = 4


def build_gt(n_gauss, n_obj, ape_dim, device, seed=3):
    """Blobs of Gaussians around n_obj centres inside a far background
    shell; semantics one-hot (x4) by object, and one unit APE feature per
    object and one for the background."""
    from goi_tpu_torch.core.scene import GaussianScene

    rng = np.random.default_rng(seed)
    per = n_gauss // (n_obj + 1)
    centers = np.stack([
        np.array([np.cos(2 * np.pi * k / n_obj),
                  0.3 * np.sin(4 * np.pi * k / n_obj),
                  np.sin(2 * np.pi * k / n_obj)], np.float32)
        for k in range(n_obj)])
    xyz, obj = [], []
    for k in range(n_obj):
        xyz.append(centers[k] + rng.normal(0, 0.22, (per, 3)))
        obj.append(np.full(per, k))
    # the background wall lies outside the camera ring, so the objects'
    # pixels stay pure
    shell = rng.normal(0, 1, (n_gauss - n_obj * per, 3))
    shell = 4.5 * shell / np.linalg.norm(shell, axis=1, keepdims=True)
    xyz.append(shell)
    obj.append(np.full(len(shell), n_obj))
    xyz = np.concatenate(xyz).astype(np.float32)
    obj = np.concatenate(obj)
    palette = rng.uniform(0.2, 1.0, (n_obj + 1, 3)).astype(np.float32)
    scene = GaussianScene.create(
        xyz, palette[obj], sh_degree=0, sem_dim=10,
        scales=np.full(len(xyz), 0.035 if n_gauss < 1e5 else 0.012,
                       np.float32), device=device)
    sems = np.zeros((len(xyz), 10), np.float32)
    sems[np.arange(len(xyz)), np.minimum(obj, 9)] = 4.0
    scene = scene.replace(
        opacity=torch.full_like(scene.opacity, 1.8),
        semantics=torch.as_tensor(sems, device=device))
    q, _ = np.linalg.qr(rng.normal(0, 1, (ape_dim, n_obj + 1)))
    feats = q.T.astype(np.float32)
    feats -= feats.mean(0, keepdims=True)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    return scene, xyz, feats


def camera_ring(n_views, w, h, device, fov=1.0):
    """(Rw2c, tvec, Camera) triples on two elevation rings."""
    from goi_tpu_torch.core.camera import Camera

    out = []
    for i in range(n_views):
        a = 2 * np.pi * i / (n_views // 2)
        hgt = 0.9 if i < n_views // 2 else 2.0
        eye = np.array([3.4 * np.sin(a), hgt, -3.4 * np.cos(a)])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, [0, 1, 0])
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        rw2c = np.stack([right, down, fwd])
        t = -rw2c @ eye
        out.append((rw2c, t, Camera.from_Rt(rw2c.T, t, fov, fov, w, h,
                                            device=device)))
    return out


def write_colmap(root, poses, w, h, fx, fy, images, sfm_xyz, sfm_rgb):
    """A COLMAP binary scene directory (one PINHOLE camera of focal
    lengths fx, fy; formats of ref:scene/colmap_loader.py) with its
    images, (3, H, W) floats in [0, 1], as PNGs."""
    from goi_tpu_torch.data.colmap import rotmat2qvec
    from goi_tpu_torch.utils.image import save_image

    sparse = os.path.join(root, "sparse/0")
    os.makedirs(sparse, exist_ok=True)
    with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 1, w, h))      # PINHOLE
        f.write(struct.pack("<dddd", fx, fy, w / 2, h / 2))
    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(poses)))
        for i, (r, t, _) in enumerate(poses):
            f.write(struct.pack("<i", i + 1))
            f.write(struct.pack("<dddd", *rotmat2qvec(r)))
            f.write(struct.pack("<ddd", *t))
            f.write(struct.pack("<i", 1))
            f.write(f"view_{i:03d}.png".encode() + b"\x00")
            f.write(struct.pack("<Q", 0))
    with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(sfm_xyz)))
        for i in range(len(sfm_xyz)):
            f.write(struct.pack("<Q", i))
            f.write(struct.pack("<ddd", *sfm_xyz[i]))
            f.write(struct.pack("<BBB", *sfm_rgb[i]))
            f.write(struct.pack("<d", 0.5))
            f.write(struct.pack("<Q", 1))
            f.write(struct.pack("<ii", 1, 0))
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    for i, img in enumerate(images):
        save_image(img, os.path.join(img_dir, f"view_{i:03d}.png"))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default="./output/rehearsal")
    ap.add_argument("--fast", action="store_true",
                    help="the test-sized configuration")
    ap.add_argument("--n", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from goi_tpu_torch import _cli
    from goi_tpu_torch import eval_seg as eval_cli
    from goi_tpu_torch import metrics as metrics_cli
    from goi_tpu_torch import render as render_cli
    from goi_tpu_torch.app.session import QuerySession
    from goi_tpu_torch.configs.params import ModelParams
    from goi_tpu_torch.data import scene as triplet
    from goi_tpu_torch.data.scene import Scene
    from goi_tpu_torch.raster.render import (RasterConfig, render,
                                             suggest_budgets)
    from goi_tpu_torch.train.__main__ import main as train_main
    from goi_tpu_torch.train.optim import OptimConfig
    from goi_tpu_torch.train.rgb import train_rgb
    from goi_tpu_torch.utils.image import save_image

    device = _cli.resolve_device(args.device)
    if args.fast:
        n_gauss, size, n_views = 4000, 64, 8
        rgb_iters, distill_iters, ape_dim, tab_len = 60, 40, 16, 16
    else:
        n_gauss, size, n_views = 80_000, 256, 16
        rgb_iters, distill_iters, ape_dim, tab_len = 2000, 600, 32, 32
    if args.n:
        n_gauss = args.n
    w = h = size
    root = args.root
    scene_dir = os.path.join(root, "scene")
    model_dir = os.path.join(root, "model")
    eval_root = os.path.join(root, "seg_gt")
    saving_root = os.path.join(root, "seg_pred")
    os.makedirs(scene_dir, exist_ok=True)

    # ---- 1. dataset synthesis --------------------------------------
    gt_scene, xyz, feats = build_gt(n_gauss, N_OBJ, ape_dim, device)
    poses = camera_ring(n_views, w, h, device)
    cams = [p[2] for p in poses]
    mi, _ = suggest_budgets(gt_scene, cams, margin=1.3)
    cfg = RasterConfig(max_instances=mi)
    bg = torch.zeros(3, device=device)
    images, masks = [], []
    noise = np.random.default_rng(1)
    feat_dir = os.path.join(scene_dir, "clip_feat")
    os.makedirs(feat_dir, exist_ok=True)
    for i, c in enumerate(cams):
        with torch.no_grad():
            out = render(gt_scene, c, bg, cfg)
        images.append(out["render"].cpu().numpy() + noise.normal(
            0, 0.02, (3, h, w)).astype(np.float32))
        wmap = out["semantics"].cpu().numpy()
        ape = np.einsum("ohw,oc->chw", wmap[:N_OBJ], feats[:N_OBJ])
        bg_w = np.maximum(1.0 - wmap[:N_OBJ].sum(0), 0.0)
        ape = ape + bg_w[None] * feats[N_OBJ][:, None, None]
        np.save(os.path.join(feat_dir, f"view_{i:03d}.npy"),
                ape.astype(np.float32))
        masks.append(np.where(wmap[:N_OBJ].max(0) > 0.2,
                              wmap[:N_OBJ].argmax(0), -1))
    rng = np.random.default_rng(0)
    sfm_xyz = xyz[::4] + rng.normal(0, 0.01, xyz[::4].shape)
    sfm_rgb = np.full((len(sfm_xyz), 3), 128, np.uint8)
    focal = w / (2.0 * np.tan(0.5))      # the ring's fov of 1 radian
    write_colmap(scene_dir, poses, w, h, focal, focal, images, sfm_xyz,
                 sfm_rgb)
    # per-prompt GT masks of the eval split (eval_seg's m360 layout:
    # eval_root/<scene>/<prompt>/masks/<view>.png)
    prompts = [f"object_{k}" for k in range(N_OBJ)]
    test_idx = list(range(0, n_views, 8))
    for k, prompt in enumerate(prompts):
        mdir = os.path.join(eval_root, "synthetic", prompt, "masks")
        os.makedirs(mdir, exist_ok=True)
        for i in test_idx:
            save_image((masks[i] == k).astype(np.float32)[None],
                       os.path.join(mdir, f"view_{i:03d}.png"))
    print(f"[1/6] dataset written: {scene_dir}", flush=True)

    # ---- 2. RGB pre-training (iteration_1 convention) ---------------
    mp = ModelParams(source_path=scene_dir, model_path=model_dir,
                     eval=True, ape_dim=ape_dim, tab_len=tab_len,
                     sh_degree=0)
    pre = Scene(mp, device=device)
    train_ids = [i for i in range(n_views) if i % 8 != 0]
    ocfg = OptimConfig(iterations=rgb_iters,
                       position_lr_max_steps=rgb_iters,
                       densify_until_iter=int(rgb_iters * 0.65))
    state, rcfg = train_rgb(
        pre.gaussians, [cams[i] for i in train_ids],
        [images[i] for i in train_ids], cfg=ocfg, raster_cfg=cfg,
        iterations=rgb_iters,
        scene_extent=pre.info.nerf_normalization["radius"],
        log_every=max(rgb_iters // 4, 1), return_raster_cfg=True)
    pre.gaussians = state.scene
    pre.save(1)
    rgb_gaussians = int(state.scene.num_valid)
    # the later stages' budget covers what the training grew to
    mi = rcfg.max_instances
    print(f"[2/6] RGB pre-train done ({rgb_iters} iters, "
          f"{rgb_gaussians} Gaussians)", flush=True)

    # ---- 3. distillation through the train CLI -----------------------
    dev = ["--device", str(device)]
    train_main(["-s", scene_dir, "-m", model_dir, "--eval",
                "--iterations", str(distill_iters),
                "--ape_dim", str(ape_dim), "--tab_len", str(tab_len),
                "--sh_degree", "0",
                "--test_iterations", str(distill_iters),
                "--save_iterations", str(distill_iters), "--quiet",
                "--max_instances", str(mi)] + dev)
    pc_dir = os.path.join(model_dir, "point_cloud",
                          f"iteration_{distill_iters}")
    print(f"[3/6] distillation artifacts: {pc_dir}", flush=True)

    # ---- 4+5. render + metrics CLIs ----------------------------------
    render_cli.main(["-m", model_dir, "--iteration", str(distill_iters),
                     "--max_instances", str(mi)] + dev)
    results = metrics_cli.evaluate([model_dir], device=device)[model_dir]
    psnr = results[f"ours_{distill_iters}"]["PSNR"]
    print(f"[4-5/6] render+metrics: PSNR {psnr:.2f}", flush=True)

    # ---- 6. open-vocabulary query -> masks -> eval_seg CLI ----------
    trained = Scene(mp, load_iteration=distill_iters, device=device)
    decoder, lut = Scene.load_semantics(pc_dir, device=device)
    cfg = RasterConfig(max_instances=mi)
    sess = QuerySession(trained.gaussians, decoder, lut, cfg,
                        sim_thresh=0.86, white_background=False,
                        device=device)
    for k, prompt in enumerate(prompts):
        pdir = os.path.join(saving_root, "synthetic", prompt)
        os.makedirs(pdir, exist_ok=True)
        sess.set_text(feats[k] * 12.0)
        for i in test_idx:
            with torch.no_grad():
                out = render(sess.scene, cams[i], sess.bg, cfg)
            sim = sess.compute_similarity(
                out["semantics"].reshape(10, -1).T)
            pred = (sim > 0).reshape(h, w).float()[None]
            save_image(pred, os.path.join(pdir, f"view_{i:03d}.png"))
    (iou, mpa, mprec), = eval_cli.main(
        ["-e", eval_root, "-s", saving_root, "--scene_list", "synthetic",
         "-d", "m360"] + dev)
    print(f"[6/6] eval_seg: mIoU {iou:.3f} mPA {mpa:.3f} mP "
          f"{mprec:.3f}", flush=True)

    summary = {
        "config": {"n_gauss": n_gauss, "size": size, "n_views": n_views,
                   "rgb_iters": rgb_iters, "rgb_gaussians": rgb_gaussians,
                   "distill_iters": distill_iters,
                   "device": str(device)},
        "psnr": round(float(psnr), 3),
        "miou": round(float(iou), 4),
        "mpa": round(float(mpa), 4),
        "mp": round(float(mprec), 4),
        "artifacts": {
            "colmap_scene": scene_dir,
            "point_cloud_ply": os.path.join(pc_dir, triplet.PLY),
            "semantic_mlp": os.path.join(pc_dir, triplet.DECODER),
            "lut": os.path.join(pc_dir, triplet.LUT),
            "results_json": os.path.join(model_dir, "results.json"),
            "per_view_json": os.path.join(model_dir, "per_view.json"),
            "cfg_args": os.path.join(model_dir, "cfg_args.json"),
            "pred_masks": saving_root,
            "gt_masks": eval_root,
        },
    }
    for p in summary["artifacts"].values():
        if not os.path.exists(p):
            raise FileNotFoundError(f"rehearsal artifact missing: {p}")
    with open(os.path.join(root, "REHEARSAL.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary, indent=1))
    return summary


if __name__ == "__main__":
    main()
