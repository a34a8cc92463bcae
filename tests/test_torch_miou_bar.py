"""The port's copy of tests/test_semantic_miou_bar.py's quality bar:
distill a fresh semantic field on a synthetic 3-object scene with
goi_tpu_torch's train_distillation (the kernels' plain versions on the
CPU), query each object by its feature vector through QuerySession, and
demand the same mIoU bar (0.85; chance is ~0.2)."""

import numpy as np
import torch

from goi_tpu_torch.app.session import QuerySession
from goi_tpu_torch.core.camera import Camera
from goi_tpu_torch.core.scene import GaussianScene
from goi_tpu_torch.raster.render import RasterConfig, render
from goi_tpu_torch.train.distill import train_distillation

torch.set_num_threads(1)

N_OBJ = 3
APE_DIM = 32
H, W = 48, 64


def _gt_scene(rng):
    centers = np.array([[-0.9, 0.0, 0.0], [0.9, 0.2, 0.3],
                        [0.0, -0.2, -0.6]], np.float32)
    palette = rng.uniform(0.3, 1.0, (N_OBJ, 3)).astype(np.float32)
    xyz, colors, obj = [], [], []
    for k in range(N_OBJ):
        p = centers[k] + rng.normal(0, 0.16, (400, 3)).astype(np.float32)
        xyz.append(p)
        colors.append(np.tile(palette[k], (400, 1)))
        obj.append(np.full(400, k))
    xyz = np.concatenate(xyz)
    obj = np.concatenate(obj)
    scene = GaussianScene.create(
        xyz, np.concatenate(colors), sh_degree=0, sem_dim=10,
        scales=np.full(len(xyz), 0.05, np.float32), device="cpu")
    sems = np.zeros((len(xyz), 10), np.float32)
    sems[np.arange(len(xyz)), obj] = 4.0
    return scene.replace(opacity=torch.full_like(scene.opacity, 1.8),
                         semantics=torch.as_tensor(sems))


def _cameras(n):
    cams = []
    for i in range(n):
        a = 2 * np.pi * i / n
        eye = [2.6 * np.sin(a), 0.7, -2.6 * np.cos(a)]
        cams.append(Camera.look_at(eye, [0, 0, 0], [0, 1, 0], fovx=1.0,
                                   fovy=0.8, width=W, height=H,
                                   device="cpu"))
    return cams


def test_distill_query_miou_bar():
    rng = np.random.default_rng(3)
    gt_scene = _gt_scene(rng)
    cams = _cameras(8)
    cfg = RasterConfig(max_instances=1 << 15)
    bg = torch.zeros(3)

    # simplex-separated features, as the JAX test lays them out
    q, _ = np.linalg.qr(rng.normal(0, 1, (APE_DIM, N_OBJ + 1)))
    basis = q.T.astype(np.float32)
    obj_feats = basis - basis.mean(0, keepdims=True)
    obj_feats /= np.linalg.norm(obj_feats, axis=1, keepdims=True)

    ape_maps, gt_masks = [], []
    with torch.no_grad():
        for c in cams:
            wmap = render(gt_scene, c, bg, cfg)["semantics"].numpy()
            ape = np.einsum("ohw,oc->chw", wmap[:N_OBJ], obj_feats[:N_OBJ])
            bg_w = np.maximum(1.0 - wmap[:N_OBJ].sum(0), 0.0)
            ape = ape + bg_w[None] * obj_feats[N_OBJ][:, None, None]
            ape_maps.append(ape.astype(np.float32))
            gt_masks.append(np.where(wmap[:N_OBJ].max(0) > 0.2,
                                     wmap[:N_OBJ].argmax(0), -1))

    fresh = gt_scene.replace(semantics=torch.zeros_like(gt_scene.semantics))
    train_idx = [i for i in range(len(cams)) if i % 4 != 0]
    dstate = train_distillation(
        fresh, [cams[i] for i in train_idx],
        [ape_maps[i] for i in train_idx], tab_len=48, iterations=240,
        raster_cfg=cfg, log_every=1000)

    sess = QuerySession(dstate.scene, dstate.decoder, dstate.lut, cfg,
                        sim_thresh=0.86, white_background=False,
                        device="cpu")
    test_idx = [i for i in range(len(cams)) if i % 4 == 0]
    per_obj = []
    for k in range(N_OBJ):
        sess.set_text(obj_feats[k] * 12.0)
        ious = []
        for i in test_idx:
            with torch.no_grad():
                out = render(sess.scene, cams[i], bg, cfg)
            sim = sess.compute_similarity(
                out["semantics"].reshape(10, -1).T)
            pred = (sim > 0).reshape(H, W).numpy()
            gt = gt_masks[i] == k
            ious.append((pred & gt).sum() / max((pred | gt).sum(), 1))
        per_obj.append(float(np.mean(ious)))

    miou = float(np.mean(per_obj))
    print(f"distill+query mIoU {miou:.3f} per-object {per_obj}")
    assert miou >= 0.85, (miou, per_obj)
