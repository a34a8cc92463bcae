"""COLMAP sparse-reconstruction parsers (binary and text).

Counterpart of goi_tpu/data/colmap.py (the role of
ref:scene/colmap_loader.py:1-284): cameras.bin/.txt, images.bin/.txt,
points3D.bin/.txt, plus quaternion <-> rotation matrix. Numpy only; the
binary images and points go through the native parser of
goi_tpu_torch/native when it builds.
"""

from __future__ import annotations

import collections
import os
import struct
from typing import Dict, Tuple

import numpy as np

CameraModel = collections.namedtuple(
    "CameraModel", ["model_id", "model_name", "num_params"])
ColmapCamera = collections.namedtuple(
    "ColmapCamera", ["id", "model", "width", "height", "params"])
ColmapImage = collections.namedtuple(
    "ColmapImage", ["id", "qvec", "tvec", "camera_id", "name",
                    "xys", "point3D_ids"])

CAMERA_MODELS = [
    CameraModel(0, "SIMPLE_PINHOLE", 3),
    CameraModel(1, "PINHOLE", 4),
    CameraModel(2, "SIMPLE_RADIAL", 4),
    CameraModel(3, "RADIAL", 5),
    CameraModel(4, "OPENCV", 8),
    CameraModel(5, "OPENCV_FISHEYE", 8),
    CameraModel(6, "FULL_OPENCV", 12),
    CameraModel(7, "FOV", 5),
    CameraModel(8, "SIMPLE_RADIAL_FISHEYE", 4),
    CameraModel(9, "RADIAL_FISHEYE", 5),
    CameraModel(10, "THIN_PRISM_FISHEYE", 12),
]
MODEL_BY_ID = {m.model_id: m for m in CAMERA_MODELS}
MODEL_BY_NAME = {m.model_name: m for m in CAMERA_MODELS}


def qvec2rotmat(qvec) -> np.ndarray:
    """COLMAP (w, x, y, z) quaternion -> rotation matrix
    (ref:scene/colmap_loader.py qvec2rotmat)."""
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z,
         2 * x * z + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z,
         2 * y * z - 2 * w * x],
        [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x,
         1 - 2 * x * x - 2 * y * y]])


def rotmat2qvec(R) -> np.ndarray:
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = np.array([
        [Rxx - Ryy - Rzz, 0, 0, 0],
        [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
        [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
        [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz]]) / 3.0
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


def _read(f, n, fmt):
    return struct.unpack("<" + fmt, f.read(n))


def read_cameras_binary(path) -> Dict[int, ColmapCamera]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, 8, "Q")
        for _ in range(n):
            cid, model_id, w, h = _read(f, 24, "iiQQ")
            model = MODEL_BY_ID[model_id]
            params = np.array(_read(f, 8 * model.num_params,
                                    "d" * model.num_params))
            out[cid] = ColmapCamera(cid, model.model_name, w, h, params)
    return out


def read_cameras_text(path) -> Dict[int, ColmapCamera]:
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cid = int(parts[0])
            out[cid] = ColmapCamera(
                cid, parts[1], int(parts[2]), int(parts[3]),
                np.array(tuple(map(float, parts[4:]))))
    return out


def read_images_binary(path) -> Dict[int, ColmapImage]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, 8, "Q")
        for _ in range(n):
            iid = _read(f, 4, "i")[0]
            qvec = np.array(_read(f, 32, "dddd"))
            tvec = np.array(_read(f, 24, "ddd"))
            cam_id = _read(f, 4, "i")[0]
            name = b""
            c = f.read(1)
            while c != b"\x00":
                name += c
                c = f.read(1)
            (npts,) = _read(f, 8, "Q")
            data = np.frombuffer(f.read(24 * npts),
                                 dtype=[("xy", "<f8", 2),
                                        ("id", "<i8")])
            out[iid] = ColmapImage(
                iid, qvec, tvec, cam_id, name.decode("utf-8"),
                np.array(data["xy"]), np.array(data["id"]))
    return out


def read_images_text(path) -> Dict[int, ColmapImage]:
    # COLMAP writes an EMPTY points2D line for images with zero 2D
    # points, so the points2D record is the line immediately following
    # each header — consumed unconditionally, possibly blank
    # (ref:scene/colmap_loader.py:252). Pre-filtering blank lines would
    # desynchronize the header/points pairing.
    out = {}
    with open(path) as f:
        it = iter(f)
        for raw in it:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            iid = int(parts[0])
            qvec = np.array(tuple(map(float, parts[1:5])))
            tvec = np.array(tuple(map(float, parts[5:8])))
            cam_id = int(parts[8])
            name = parts[9]
            elems = next(it, "").strip().split()
            xys = np.array(tuple(map(float, elems))).reshape(-1, 3) \
                if elems else np.zeros((0, 3))
            out[iid] = ColmapImage(iid, qvec, tvec, cam_id, name,
                                   xys[:, :2], xys[:, 2].astype(np.int64))
    return out


def read_points3d_binary(path) -> Tuple[np.ndarray, np.ndarray,
                                        np.ndarray]:
    """Returns (xyz (N,3) f64, rgb (N,3) u8, errors (N,))."""
    with open(path, "rb") as f:
        (n,) = _read(f, 8, "Q")
        xyz = np.empty((n, 3))
        rgb = np.empty((n, 3), np.uint8)
        err = np.empty(n)
        for i in range(n):
            rec = _read(f, 43, "QdddBBBd")
            xyz[i] = rec[1:4]
            rgb[i] = rec[4:7]
            err[i] = rec[7]
            (tl,) = _read(f, 8, "Q")
            f.seek(8 * tl, os.SEEK_CUR)
    return xyz, rgb, err


def read_points3d_text(path):
    xyz, rgb, err = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            xyz.append(tuple(map(float, parts[1:4])))
            rgb.append(tuple(map(int, parts[4:7])))
            err.append(float(parts[7]))
    return (np.array(xyz), np.array(rgb, np.uint8), np.array(err))


def _read_points3d_fast(path):
    """Native C++ parser when available (large models are Python-loop
    bound otherwise; see goi_tpu_torch/native/), else the pure-Python
    walk."""
    from goi_tpu_torch.native.loader import read_points3d_binary_native
    out = read_points3d_binary_native(path)
    return out if out is not None else read_points3d_binary(path)


def _read_images_fast(path):
    from goi_tpu_torch.native.loader import read_images_binary_native
    out = read_images_binary_native(path)
    return out if out is not None else read_images_binary(path)


def read_model(sparse_dir: str):
    """Auto-detect binary vs text model files
    (ref:scene/dataset_readers.py:139-151 fallback behavior)."""
    def pick(stem, rb, rt):
        b = os.path.join(sparse_dir, stem + ".bin")
        t = os.path.join(sparse_dir, stem + ".txt")
        if os.path.exists(b):
            return rb(b)
        return rt(t)

    cams = pick("cameras", read_cameras_binary, read_cameras_text)
    imgs = pick("images", _read_images_fast, read_images_text)
    pts = pick("points3D", _read_points3d_fast, read_points3d_text)
    return cams, imgs, pts
