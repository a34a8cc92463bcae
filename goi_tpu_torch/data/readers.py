"""Scene readers: COLMAP, Blender (NeRF-synthetic), ScanNet.

Counterpart of goi_tpu/data/readers.py (the role of
ref:scene/dataset_readers.py:136-387), with the same conventions:
llffhold=8 eval split, clip_feat/<name>.pt per-image APE feature files,
NeRF++ camera-extent normalization, sparse/0 layout, stride-8 ScanNet
frames. Images and features are referenced by path and loaded when a
caller needs them (data/dataset.py), so large scenes stream.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from goi_tpu_torch.core.camera import focal2fov, fov2focal, get_world2view
from goi_tpu_torch.core.ply import read_ply, write_ply
from goi_tpu_torch.data.colmap import qvec2rotmat, read_model
from goi_tpu_torch.utils.image import image_size


@dataclasses.dataclass
class CameraInfo:
    uid: int
    R: np.ndarray           # cam-to-world rotation (W2C^T), COLMAP style
    T: np.ndarray           # W2C translation
    fovx: float
    fovy: float
    width: int
    height: int
    image_path: str
    image_name: str
    semantic_path: Optional[str] = None


@dataclasses.dataclass
class SceneInfo:
    point_cloud: Optional[dict]      # {"points": (N,3), "colors": (N,3)}
    train_cameras: List[CameraInfo]
    test_cameras: List[CameraInfo]
    nerf_normalization: dict
    ply_path: str


def get_nerfpp_norm(cam_infos: List[CameraInfo]) -> dict:
    """Camera-extent normalization (ref:scene/dataset_readers.py:39-60):
    radius = 1.1 * max distance of any camera center from their mean."""
    centers = []
    for cam in cam_infos:
        w2c = get_world2view(cam.R, cam.T)
        centers.append(np.linalg.inv(w2c)[:3, 3])
    centers = np.stack(centers, 0)
    avg = centers.mean(0)
    diagonal = np.linalg.norm(centers - avg, axis=1).max()
    return {"translate": -avg, "radius": float(diagonal * 1.1)}


def _fetch_ply_points(path: str) -> Optional[dict]:
    try:
        v = read_ply(path)
    except (OSError, ValueError, KeyError):
        return None
    pts = np.stack([v["x"], v["y"], v["z"]], 1).astype(np.float32)
    if "red" in v:
        colors = np.stack([v["red"], v["green"], v["blue"]], 1) / 255.0
    else:
        colors = np.full_like(pts, 0.5)
    return {"points": pts, "colors": colors.astype(np.float32)}


def _store_ply_points(path: str, xyz: np.ndarray, rgb: np.ndarray):
    write_ply(path, {
        "x": xyz[:, 0].astype(np.float32),
        "y": xyz[:, 1].astype(np.float32),
        "z": xyz[:, 2].astype(np.float32),
        "nx": np.zeros(len(xyz), np.float32),
        "ny": np.zeros(len(xyz), np.float32),
        "nz": np.zeros(len(xyz), np.float32),
        "red": rgb[:, 0].astype(np.uint8),
        "green": rgb[:, 1].astype(np.uint8),
        "blue": rgb[:, 2].astype(np.uint8),
    })


def read_colmap_scene(path: str, images: str = "images",
                      eval_split: bool = False, llffhold: int = 8,
                      load_sem: bool = True) -> SceneInfo:
    """(ref:scene/dataset_readers.py:136-181)."""
    cams, imgs, (xyz, rgb, _) = read_model(os.path.join(path, "sparse/0"))

    infos = []
    img_dir = os.path.join(path, images)
    for iid, extr in imgs.items():
        intr = cams[extr.camera_id]
        if intr.model == "SIMPLE_PINHOLE":
            fx = fy = intr.params[0]
        elif intr.model == "PINHOLE":
            fx, fy = intr.params[0], intr.params[1]
        else:
            raise ValueError(
                f"unsupported COLMAP camera model {intr.model}; "
                "undistort first (PINHOLE/SIMPLE_PINHOLE only)")
        R = qvec2rotmat(extr.qvec).T
        T = np.array(extr.tvec)
        if np.isnan(R).any() or np.isnan(T).any():
            continue
        name = os.path.basename(extr.name).split(".")[0]
        sem_path = os.path.join(path, "clip_feat", f"{name}.pt")
        infos.append(CameraInfo(
            uid=intr.id, R=R, T=T,
            fovx=focal2fov(fx, intr.width),
            fovy=focal2fov(fy, intr.height),
            width=intr.width, height=intr.height,
            image_path=os.path.join(img_dir, os.path.basename(extr.name)),
            image_name=name,
            semantic_path=sem_path if load_sem else None))
    infos.sort(key=lambda c: c.image_name)

    if eval_split:
        train = [c for i, c in enumerate(infos) if i % llffhold != 0]
        test = [c for i, c in enumerate(infos) if i % llffhold == 0]
    else:
        train, test = infos, []

    ply_path = os.path.join(path, "sparse/0/points3D.ply")
    if not os.path.exists(ply_path):
        try:
            _store_ply_points(ply_path, xyz, rgb)
        except OSError:
            pass
    pcd = _fetch_ply_points(ply_path) or {
        "points": xyz.astype(np.float32),
        "colors": (rgb / 255.0).astype(np.float32)}

    return SceneInfo(point_cloud=pcd, train_cameras=train,
                     test_cameras=test,
                     nerf_normalization=get_nerfpp_norm(train),
                     ply_path=ply_path)


def read_blender_scene(path: str, white_background: bool = False,
                       eval_split: bool = False, extension: str = ".png",
                       load_sem: bool = True) -> SceneInfo:
    """transforms_{train,test}.json reader
    (ref:scene/dataset_readers.py:183-269). Camera axes convert from
    OpenGL/Blender (Y up, Z back) to COLMAP (Y down, Z forward)."""

    def read_split(fname):
        out = []
        fpath = os.path.join(path, fname)
        if not os.path.exists(fpath):
            return out
        with open(fpath) as f:
            contents = json.load(f)
        fovx = contents["camera_angle_x"]
        for idx, frame in enumerate(contents["frames"]):
            cam_name = os.path.join(path, frame["file_path"] + extension)
            c2w = np.array(frame["transform_matrix"])
            c2w[:3, 1:3] *= -1
            w2c = np.linalg.inv(c2w)
            R = w2c[:3, :3].T
            T = w2c[:3, 3]
            w, h = image_size(cam_name)
            fovy = focal2fov(fov2focal(fovx, w), h)
            sem_path = os.path.join(path, f"clip_feat/{idx + 1}.pt")
            out.append(CameraInfo(
                uid=idx, R=R, T=T, fovx=fovx, fovy=fovy, width=w,
                height=h, image_path=cam_name,
                image_name=Path(cam_name).stem,
                semantic_path=sem_path if load_sem else None))
        return out

    train = read_split("transforms_train.json")
    test = read_split("transforms_test.json")
    if not eval_split:
        train = train + test
        test = []

    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        num_pts = 100_000
        xyz = np.random.random((num_pts, 3)) * 2.6 - 1.3
        rgb = np.random.random((num_pts, 3)) * 255.0 / 255.0
        _store_ply_points(ply_path, xyz, rgb * 255)
    pcd = _fetch_ply_points(ply_path)

    return SceneInfo(point_cloud=pcd, train_cameras=train,
                     test_cameras=test,
                     nerf_normalization=get_nerfpp_norm(train),
                     ply_path=ply_path)


def read_scannet_scene(path: str, eval_split: bool = False,
                       llffhold: int = 8, stride: int = 8) -> SceneInfo:
    """ScanNet layout (ref:scene/dataset_readers.py:274-381): <scene>.txt
    intrinsics, image/pose/<i>.txt c2w mats, image/color/<i>.jpg frames
    every `stride`, clip_feat/<i>.pt features."""
    scene_id = str(path).rstrip("/")[-12:]
    intr: Dict = {}
    with open(os.path.join(path, scene_id + ".txt")) as f:
        for line in f:
            if "=" in line:
                k, v = (s.strip() for s in line.split("=", 1))
                intr[k] = v
    width = int(intr["colorWidth"])
    height = int(intr["colorHeight"])
    fx, fy = float(intr["fx_color"]), float(intr["fy_color"])
    n_frames = int(intr["numColorFrames"])

    infos = []
    for idx in range(0, n_frames, stride):
        c2w = np.loadtxt(os.path.join(path, f"image/pose/{idx}.txt"))
        if np.isnan(c2w).any() or np.isinf(c2w).any():
            continue
        w2c = np.linalg.inv(c2w)
        infos.append(CameraInfo(
            uid=idx, R=w2c[:3, :3].T, T=w2c[:3, 3],
            fovx=focal2fov(fx, width), fovy=focal2fov(fy, height),
            width=width, height=height,
            image_path=os.path.join(path, f"image/color/{idx}.jpg"),
            image_name=str(idx),
            semantic_path=os.path.join(path, f"clip_feat/{idx}.pt")))
    infos.sort(key=lambda c: c.image_name)

    if eval_split:
        train = [c for i, c in enumerate(infos) if i % llffhold != 0]
        test = [c for i, c in enumerate(infos) if i % llffhold == 0]
    else:
        train, test = infos, []

    ply_path = os.path.join(path, scene_id + "_vh_clean_2.ply")
    pcd = _fetch_ply_points(ply_path)

    return SceneInfo(point_cloud=pcd, train_cameras=train,
                     test_cameras=test,
                     nerf_normalization=get_nerfpp_norm(train),
                     ply_path=ply_path)


def load_scene_info(path: str, *, images: str = "images",
                    eval_split: bool = False, white_background: bool = False,
                    load_sem: bool = True) -> SceneInfo:
    """Dataset-type dispatch (ref:scene/__init__.py:33-39): sparse/ =>
    COLMAP, transforms_train.json => Blender, otherwise ScanNet."""
    if os.path.exists(os.path.join(path, "sparse")):
        return read_colmap_scene(path, images, eval_split,
                                 load_sem=load_sem)
    if os.path.exists(os.path.join(path, "transforms_train.json")):
        return read_blender_scene(path, white_background, eval_split,
                                  load_sem=load_sem)
    return read_scannet_scene(path, eval_split)
