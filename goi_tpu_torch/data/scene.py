"""Scene orchestration and the trained-scene triplet on disk.

Counterpart of goi_tpu/data/scene.py (the role of
ref:scene/__init__.py:11-83): `Scene` reads a dataset, creates the
Gaussians from its point cloud or loads them from
`model_path/point_cloud/iteration_<N>/` (max-iteration search,
ref:utils/system_utils.py:26-28), and saves the PLY + decoder + LUT
triplet there (ref:train.py:184-189): `point_cloud.ply`,
`semantic_MLP.pt` (a pickle of numpy arrays) and `LUT.npy`. Files
written here load in the JAX package and the reverse. Every tensor goes
to an explicit `device`.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np
import torch

from goi_tpu_torch.configs.params import ModelParams
from goi_tpu_torch.core.camera import Camera, get_world2view
from goi_tpu_torch.core.ply import load_gaussians_ply, save_gaussians_ply
from goi_tpu_torch.core.scene import GaussianScene
from goi_tpu_torch.data.dataset import build_cameras
from goi_tpu_torch.data.readers import SceneInfo, load_scene_info
from goi_tpu_torch.semantic.codebook import SemanticDecoder

PLY = "point_cloud.ply"
DECODER = "semantic_MLP.pt"
LUT = "LUT.npy"


def save(out_dir: str, scene, decoder=None, lut=None) -> str:
    os.makedirs(out_dir, exist_ok=True)
    save_gaussians_ply(os.path.join(out_dir, PLY), scene)
    if decoder is not None:
        decoder.save(os.path.join(out_dir, DECODER))
    if lut is not None:
        np.save(os.path.join(out_dir, LUT), lut.detach().cpu().numpy())
    return out_dir


def load_semantics(out_dir: str, device="cuda"):
    """The (decoder, LUT) pair saved by `save` in either package."""
    decoder = SemanticDecoder.load(os.path.join(out_dir, DECODER),
                                   device=device)
    lut = torch.as_tensor(np.load(os.path.join(out_dir, LUT)),
                          device=device)
    return decoder, lut


def load(out_dir: str, *, sem_dim: int = 10, device="cuda"):
    """(scene, decoder, LUT) from a directory written by `save`."""
    scene = load_gaussians_ply(os.path.join(out_dir, PLY), sem_dim=sem_dim,
                               device=device)
    return (scene, *load_semantics(out_dir, device=device))


def search_max_iteration(folder: str) -> Optional[int]:
    """(ref:utils/system_utils.py:26-28)."""
    if not os.path.isdir(folder):
        return None
    its = [int(d.split("_")[-1]) for d in os.listdir(folder)
           if d.startswith("iteration_")]
    return max(its) if its else None


class Scene:
    """Loads the dataset and the Gaussians; owns the checkpoint
    directory. load_iteration: None creates the Gaussians from the point
    cloud, -1 loads the latest saved iteration, N loads iteration N."""

    def __init__(self, params: ModelParams,
                 load_iteration: Optional[int] = None,
                 capacity: Optional[int] = None,
                 load_sem: bool = True, device="cuda"):
        self.params = params
        self.model_path = params.model_path
        self.device = torch.device(device)
        self.info: SceneInfo = load_scene_info(
            params.source_path, images=params.images,
            eval_split=params.eval,
            white_background=params.white_background, load_sem=load_sem)
        self.train_cameras: List[Camera] = build_cameras(
            self.info.train_cameras, params.resolution, device=device)
        self.test_cameras: List[Camera] = build_cameras(
            self.info.test_cameras, params.resolution, device=device)
        self.cameras_extent = self.info.nerf_normalization["radius"]

        self.loaded_iter = None
        if load_iteration is not None:
            self.loaded_iter = (
                search_max_iteration(
                    os.path.join(self.model_path, "point_cloud"))
                if load_iteration == -1 else load_iteration)

        if self.loaded_iter is not None:
            ply = os.path.join(self.model_path, "point_cloud",
                               f"iteration_{self.loaded_iter}", PLY)
            self.gaussians = load_gaussians_ply(
                ply, sh_degree=params.sh_degree, sem_dim=params.sem_dim,
                capacity=capacity, device=device)
        else:
            self.gaussians = self._create_from_pcd(capacity)
            self._export_inputs()

    def _create_from_pcd(self, capacity: Optional[int]) -> GaussianScene:
        """create_from_pcd with the reference's 4x subsample and mean
        3-NN scale init (ref:scene/gaussian_model.py:133-161)."""
        from goi_tpu_torch.knn.knn import init_scales_from_points

        pcd = self.info.point_cloud
        if pcd is None:
            raise FileNotFoundError(
                f"no input point cloud for {self.params.source_path}")
        pts = np.asarray(pcd["points"])
        # the reference takes the kNN distances of the whole cloud
        scales = init_scales_from_points(pts, device=self.device)[::4]
        return GaussianScene.create(
            pts[::4], np.asarray(pcd["colors"])[::4],
            sh_degree=self.params.sh_degree, sem_dim=self.params.sem_dim,
            scales=scales, capacity=capacity, device=self.device)

    def _export_inputs(self):
        """cameras.json export (ref:scene/__init__.py:41-53)."""
        if not self.model_path:
            return
        os.makedirs(self.model_path, exist_ok=True)
        cams = []
        for i, c in enumerate(self.info.train_cameras):
            c2w = np.linalg.inv(get_world2view(c.R, c.T))
            cams.append({
                "id": i, "img_name": c.image_name,
                "width": c.width, "height": c.height,
                "position": c2w[:3, 3].tolist(),
                "rotation": c2w[:3, :3].tolist(),
                "fx": float(c.width / (2 * np.tan(c.fovx / 2))),
                "fy": float(c.height / (2 * np.tan(c.fovy / 2))),
            })
        with open(os.path.join(self.model_path, "cameras.json"),
                  "w") as f:
            json.dump(cams, f)

    def save(self, iteration: int, decoder=None, lut=None) -> str:
        """The PLY + decoder + LUT triplet of `iteration`."""
        return save(os.path.join(self.model_path, "point_cloud",
                                 f"iteration_{iteration}"),
                    self.gaussians, decoder, lut)

    load_semantics = staticmethod(load_semantics)
