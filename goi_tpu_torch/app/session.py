"""Headless query/editing session: the GUI's model-side logic.

Counterpart of goi_tpu/app/session.py:

- per-frame render + open-vocabulary similarity overlay
  (ref:gui/main.py:549-604 test_step, :363-398 compute_similarity)
- 3D retrieval / segmentation / deletion / move via per-Gaussian
  similarity and a motion vector (ref:gui/main.py:400-405,516-531,
  1168-1227)
- OSH fine-tuning from a RES mask (ref:gui/main.py:1673-1763)
- DBSCAN instance grouping with view-consistency filtering
  (ref:gui/main.py:1595-1671), through app/dbscan.py on the device
- query masks on disk and their scores against ground-truth masks
  (ref:gui/main.py:1938-2016, gui/main_test.py:628-687)
- anchor-pose video paths (ref:gui/main.py:1766-1821)

A frame is an eager sequence of launches on the session's device.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from goi_tpu_torch.app.dbscan import dbscan
from goi_tpu_torch.core.camera import Camera
from goi_tpu_torch.core.scene import GaussianScene
from goi_tpu_torch.eval.metrics import iou_metrics
from goi_tpu_torch.query.osh import (OSHState, osh_finetune, osh_init,
                                     osh_predict)
from goi_tpu_torch.query.similarity import ape_similarity
from goi_tpu_torch.raster.render import RasterConfig, render
from goi_tpu_torch.semantic.codebook import SemanticDecoder
from goi_tpu_torch.utils.image import (compute_mask_ratio, save_image,
                                       turbo_colormap)
from goi_tpu_torch.utils.pose import interpolate_poses
from goi_tpu_torch.utils.profiling import span


def _normed_codebook_features(decoder, lut, features):
    dec = decoder(features)
    if lut is not None:
        code = torch.argmax(torch.softmax(dec * 10.0, dim=-1), dim=-1)
        feat = lut[code]
    else:
        feat = dec
    return feat / torch.clamp(torch.linalg.norm(feat, dim=-1, keepdim=True),
                              min=1e-12)


def _frame(scene, cam, bg, gmask, decoder, lut, text, osh, *, cfg, mode,
           branch, scaling_modifier, sim_thresh, log_scale, as_u8=False):
    """One viewer frame: render + similarity + turbo-heat composite, the
    math of the JAX package's `_frame_device`."""
    def finish(img):
        if as_u8:
            return (torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8)
        return img

    out = render(scene, cam, bg, cfg, scaling_modifier=scaling_modifier,
                 gaussian_mask=gmask)
    with span("query.overlay"):
        if mode == "depth":
            d = out["depth"][0]
            d = (d - d.min()) / torch.clamp(d.max() - d.min(), min=1e-9)
            return finish(torch.stack([d] * 3, -1))
        if mode == "alpha":
            return finish(torch.stack([out["alpha"][0]] * 3, -1))
        img = out["render"].permute(1, 2, 0)
        if branch == "none":
            return finish(img)
        s, h, w = out["semantics"].shape
        normed = _normed_codebook_features(
            decoder, lut, out["semantics"].reshape(s, -1).T)
        if branch == "osh":
            sim = torch.sigmoid(osh_predict(osh, normed))
            thresh = 0.5
        else:
            sim = ape_similarity(normed, text, log_scale=log_scale)
            thresh = sim_thresh
        sim = torch.where(sim < thresh, torch.zeros_like(sim), sim)
        bg_mask = sim == 0
        # clip_color(thresh=0.7, coloring=True), inlined
        if branch == "osh":
            rel = torch.clamp(sim + 0.2, 0.1, 0.9)
        else:
            rel = torch.clamp((sim - 0.7 - 0.05) / (sim.max() - 0.7), 0.0,
                              1.0)
        heat = turbo_colormap(rel)
        heat = torch.where(bg_mask[:, None], torch.ones_like(heat), heat)
        heat = torch.clamp(heat.reshape(h, w, 3), 0, 1)
        if branch == "osh":
            alpha = bg_mask.to(torch.float32).reshape(h, w, 1)
        else:
            alpha = 1.0
        opa = alpha * 0.4
        return finish(torch.clamp(heat * opa + img * (1 - opa), 0, 1))


class QuerySession:
    def __init__(self, scene: GaussianScene, decoder: SemanticDecoder,
                 lut: Optional[torch.Tensor],
                 raster_cfg: RasterConfig = RasterConfig(),
                 sim_thresh: float = 0.86, white_background: bool = True,
                 device="cuda"):
        self.device = torch.device(device)
        self.scene = scene.to(self.device)
        self.decoder = decoder.to(self.device)
        self.lut = None if lut is None else lut.to(self.device)
        self.raster_cfg = raster_cfg
        self.sim_thresh = sim_thresh  # ref:gui default clip_feature_thresh
        self.bg = (torch.ones(3, device=self.device) if white_background
                   else torch.zeros(3, device=self.device))

        self.text_tokens: Optional[torch.Tensor] = None  # aligned (C,)
        self.log_scale: float = 0.0
        self.osh: Optional[OSHState] = None
        self.res_finetuned = False

        # retrieval state (ref:gui/main.py:1168-1227), host-side
        self.rel_gs_index: Optional[np.ndarray] = None
        self.gs_index: Optional[np.ndarray] = None
        self.motion = np.zeros(tuple(scene.xyz.shape), np.float32)
        # positions before the first move since the last retrieve/reset,
        # so that reset restores them exactly
        self._rest_xyz: Optional[torch.Tensor] = None

    # ---- text / similarity ----
    def set_text(self, aligned_tokens, log_scale: float = 0.0) -> None:
        """Set the query embedding (an aligned text embedding,
        ref:gui/main.py:105-111)."""
        self.text_tokens = torch.as_tensor(
            aligned_tokens, dtype=torch.float32,
            device=self.device).reshape(-1)
        self.log_scale = log_scale
        self.res_finetuned = False

    @torch.no_grad()
    def compute_similarity(self, features: torch.Tensor) -> torch.Tensor:
        """(pixels-or-gaussians, S) -> similarity with sub-threshold
        values zeroed (ref:gui/main.py:363-385)."""
        normed = _normed_codebook_features(self.decoder, self.lut, features)
        if self.res_finetuned and self.osh is not None:
            sim = torch.sigmoid(osh_predict(self.osh, normed))
            thresh = 0.5
        else:
            if self.text_tokens is None:
                return torch.zeros(features.shape[0], device=features.device)
            sim = ape_similarity(normed, self.text_tokens,
                                 log_scale=self.log_scale)
            thresh = self.sim_thresh
        return torch.where(sim < thresh, torch.zeros_like(sim), sim)

    # ---- per-frame ----
    @torch.no_grad()
    def render_view(self, cam, mode: str = "image", overlay: bool = True,
                    scaling_modifier: float = 1.0,
                    as_u8: bool = False) -> np.ndarray:
        """One viewer frame: render + optional similarity heat overlay
        (ref:gui/main.py:549-604). Returns (H, W, 3) float (uint8 with
        as_u8) on the host."""
        with span("query.frame"):
            gmask = None
            if self.gs_index is not None:
                gmask = torch.as_tensor(self.gs_index, device=self.device)
            branch = "none"
            text = osh = None
            if mode == "image" and overlay:
                if self.res_finetuned and self.osh is not None:
                    branch = "osh"
                    osh = self.osh
                elif self.text_tokens is not None:
                    branch = "ape"
                    text = self.text_tokens
            img = _frame(self.scene, cam.to(self.device), self.bg, gmask,
                         self.decoder, self.lut, text, osh,
                         cfg=self.raster_cfg, mode=mode, branch=branch,
                         scaling_modifier=float(scaling_modifier),
                         sim_thresh=self.sim_thresh,
                         log_scale=float(self.log_scale), as_u8=as_u8)
            with span("query.to_host"):
                return img.cpu().numpy()

    # ---- OSH fine-tune (ref:gui/main.py:1673-1763) ----
    def finetune_with_res(self, cam, res_mask: np.ndarray,
                          max_epochs: int = 8000):
        """Fit the OSH hyperplane, initialized from the text embedding,
        to a RES mask of the view `cam`; the overlay then uses it.
        Returns (IoU, epochs)."""
        if self.text_tokens is None:
            raise ValueError("set_text first (OSH inits from the text "
                             "embedding, ref:gui/main.py:1678-1680)")
        with torch.no_grad():
            out = render(self.scene, cam.to(self.device), self.bg,
                         self.raster_cfg)
            s = out["semantics"].shape[0]
            normed = _normed_codebook_features(
                self.decoder, self.lut, out["semantics"].reshape(s, -1).T)
        self.osh = osh_init(self.text_tokens)
        self.osh, iou, epochs = osh_finetune(
            self.osh, normed,
            torch.as_tensor(np.asarray(res_mask).reshape(-1),
                            device=self.device),
            max_epochs=max_epochs)
        self.res_finetuned = True
        return float(iou), int(epochs)

    # ---- 3D retrieval / editing ----
    def compute_relative_gs_index(self) -> np.ndarray:
        """Per-Gaussian membership of the current query
        (ref:gui/main.py:400-405)."""
        sims = self.compute_similarity(self.scene.get_semantics())
        return (sims > 0).cpu().numpy() & self.scene.valid.cpu().numpy()

    def retrieve(self) -> np.ndarray:
        self.rel_gs_index = self.compute_relative_gs_index()
        self.motion = np.zeros_like(self.motion)
        self._rest_xyz = None
        return self.rel_gs_index

    def segment(self) -> None:
        """Show only the retrieved object (ref:gui/main.py:1183-1185)."""
        self.gs_index = self.rel_gs_index

    def delete_view(self) -> None:
        """Hide the retrieved object (ref:gui/main.py:1192-1194)."""
        self.gs_index = ~self.rel_gs_index

    def delete_permanently(self) -> None:
        """Prune matching Gaussians (ref:gui/main.py:516-524): clear their
        validity bits."""
        crop = self.compute_similarity(self.scene.get_semantics()) > 0
        self.scene = self.scene.replace(valid=self.scene.valid & ~crop)

    def move(self, delta) -> None:
        """Translate the retrieved subset (ref:gui/main.py:1418-1496);
        accumulated in self.motion, the positions before the first move
        kept for reset."""
        if self.rel_gs_index is None:
            return
        d = np.asarray(delta, np.float32)
        self.motion = self.motion + self.rel_gs_index[:, None] * d
        if self._rest_xyz is None:
            self._rest_xyz = self.scene.xyz
        self.scene = self.scene.replace(
            xyz=self._rest_xyz + torch.as_tensor(self.motion,
                                                 device=self.device))

    def reset_motion(self) -> None:
        """Undo the moves (the positions before them, bit for bit) and
        show every Gaussian again."""
        if self._rest_xyz is not None:
            self.scene = self.scene.replace(xyz=self._rest_xyz)
        self._rest_xyz = None
        self.motion = np.zeros_like(self.motion)
        self.gs_index = None

    def adopt_scene(self, scene: GaussianScene) -> None:
        """Take `scene`, an edit of the session's (the same Gaussians), as
        the session's: the moves since the last retrieve or reset stay
        undoable, the edit kept (reset subtracts the motion, as the JAX
        package's does)."""
        scene = scene.to(self.device)
        if self._rest_xyz is not None:
            self._rest_xyz = scene.xyz - torch.as_tensor(
                self.motion, device=self.device)
        self.scene = scene

    # ---- instance grouping (ref:gui/main.py:1595-1671) ----
    def group_points(self, cam, res_mask: np.ndarray, eps: float = 0.35,
                     min_samples: int = 600,
                     ratio_thresh: float = 0.7) -> np.ndarray:
        """Split the retrieved Gaussians into DBSCAN clusters of their
        positions and keep the clusters whose own query mask in view
        `cam` lies mostly inside `res_mask` (|cluster & res| / |cluster|
        > ratio_thresh). Sets and returns the new retrieval."""
        target = self.rel_gs_index.copy()
        sel_idx = np.nonzero(target)[0]
        pts = self.scene.xyz[torch.as_tensor(sel_idx, device=self.device)]
        clusters = dbscan(pts, eps, min_samples).cpu().numpy()
        keep = np.zeros_like(target)
        for cid in range(int(clusters.max(initial=-1)) + 1):
            tmp = np.zeros_like(target)
            tmp[sel_idx[clusters == cid]] = True
            with torch.no_grad():
                out = render(self.scene, cam.to(self.device), self.bg,
                             self.raster_cfg,
                             semantic_masks=torch.as_tensor(
                                 tmp, dtype=torch.float32,
                                 device=self.device))
                s = out["semantics"].shape[0]
                sim = self.compute_similarity(
                    out["semantics"].reshape(s, -1).T)
            if float(sim.sum()) == 0:
                continue
            sem_mask = (sim > 0).reshape(cam.height, cam.width).cpu().numpy()
            if compute_mask_ratio(sem_mask, res_mask) > ratio_thresh:
                keep |= tmp
        self.rel_gs_index = keep
        return keep

    # ---- eval (ref:gui/main.py:1938-2016, gui/main_test.py:628-687) ----
    @torch.no_grad()
    def _query_mask(self, cam) -> torch.Tensor:
        out = render(self.scene, cam.to(self.device), self.bg,
                     self.raster_cfg)
        s = out["semantics"].shape[0]
        sim = self.compute_similarity(out["semantics"].reshape(s, -1).T)
        return (sim > 0).reshape(cam.height, cam.width)

    def render_query_masks(self, cameras, out_dir: str,
                           names: Optional[List[str]] = None) -> list:
        """Render the current query's binary masks for each camera and
        save them as PNGs, the artifact eval_seg scores (white = match).
        Returns the paths."""
        os.makedirs(out_dir, exist_ok=True)
        paths = []
        for i, cam in enumerate(cameras):
            name = names[i] if names else f"{i:05d}"
            p = os.path.join(out_dir, f"{name}.png")
            save_image(self._query_mask(cam).to(torch.float32)[None], p)
            paths.append(p)
        return paths

    def eval_against_gt(self, cameras, gt_masks) -> dict:
        """mIoU / mPA / mP of the current query against ground-truth
        masks, averaged over the views (ref:gui/main_test.py:628-687
        eval_epoch)."""
        agg = {"iou": [], "mpa": [], "mp": []}
        for cam, gt in zip(cameras, gt_masks):
            m = iou_metrics(self._query_mask(cam), torch.as_tensor(
                np.asarray(gt) > 0, device=self.device))
            for k in agg:
                agg[k].append(float(m[k]))
        return {k: float(np.mean(v)) for k, v in agg.items()}

    # ---- video (ref:gui/main.py:1766-1821) ----
    def render_path(self, anchor_c2ws: List[np.ndarray], width: int,
                    height: int, fovx: float, fovy: float,
                    steps_per_segment: int = 30,
                    mode: str = "image") -> List[np.ndarray]:
        """Frames (render_view) along the slerp/lerp path through the
        COLMAP-convention c2w anchor poses."""
        frames = []
        for c2w in interpolate_poses(anchor_c2ws, steps_per_segment):
            w2c = np.linalg.inv(c2w)
            cam = Camera.from_Rt(w2c[:3, :3].T, w2c[:3, 3], fovx, fovy,
                                 width, height, device=self.device)
            frames.append(self.render_view(cam, mode=mode))
        return frames
