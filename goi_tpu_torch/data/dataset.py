"""Camera, image and feature-map loading.

Counterpart of goi_tpu/data/dataset.py (the role of
ref:utils/camera_utils.py:28-79: the resolution policy with its >1.6k
auto-downscale warning, and the per-camera feature loading of
ref:scene/dataset_readers.py:98-102). Feature maps are the reference's
offline APE extraction, one torch .pt file per image (README:66-74), or
.npy. Images decode through utils/image.py; cameras go to `device`.
"""

from __future__ import annotations

import os
import warnings
from typing import List, Optional, Tuple

import numpy as np
import torch

from goi_tpu_torch.core.camera import Camera
from goi_tpu_torch.data.readers import CameraInfo
from goi_tpu_torch.utils.image import read_image, resize_image

_WARNED = [False]


def resolve_resolution(width: int, height: int, resolution: int = -1
                       ) -> Tuple[int, int]:
    """Reference resolution policy (ref:utils/camera_utils.py:31-60):
    resolution > 0 divides; -1 auto-downscales so width <= 1600."""
    if resolution in (1, 2, 4, 8):
        scale = resolution
    elif resolution == -1:
        if width > 1600:
            if not _WARNED[0]:
                warnings.warn(
                    "Encountered quite large input images (>1.6K "
                    "pixels width), rescaling to 1.6K. If this is not "
                    "desired, please explicitly specify '--resolution/-r'"
                    " as 1")
                _WARNED[0] = True
            scale = width / 1600
        else:
            scale = 1
    else:
        scale = resolution
    return round(width / scale), round(height / scale)


def build_cameras(infos: List[CameraInfo], resolution: int = -1,
                  device="cuda") -> List[Camera]:
    return [
        Camera.from_Rt(c.R, c.T, c.fovx, c.fovy,
                       *resolve_resolution(c.width, c.height, resolution),
                       device=device)
        for c in infos
    ]


def load_image(info: CameraInfo, resolution: int = -1) -> np.ndarray:
    """(3, H, W) float32 in [0,1], resized (Lanczos) per the resolution
    policy."""
    w, h = resolve_resolution(info.width, info.height, resolution)
    arr = read_image(info.image_path, "RGB")
    if arr.shape[:2] != (h, w):
        arr = resize_image(arr, w, h, "lanczos")
    arr = arr.astype(np.float32) / 255.0
    return np.clip(arr.transpose(2, 0, 1), 0.0, 1.0)


def load_feature_map(path: Optional[str]) -> Optional[np.ndarray]:
    """An offline-extracted (C, H, W) feature map as float32 (.pt, or
    .npy beside or in place of it); None when there is none."""
    if path is None or not os.path.exists(path):
        npy = path and (os.path.splitext(path)[0] + ".npy")
        if npy and os.path.exists(npy):
            return np.asarray(np.load(npy), np.float32)
        return None
    if path.endswith(".npy"):
        return np.asarray(np.load(path), np.float32)
    t = torch.load(path, map_location="cpu", weights_only=True)
    return t.float().numpy()
