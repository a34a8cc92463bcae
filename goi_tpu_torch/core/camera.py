"""Camera model and projective math.

Matrices are stored in column-vector form (`p' = M @ [p;1]`); the
reference stores the transposes (ref:scene/cameras.py:45-48).

- `world_view`: world -> camera 4x4 (ref:utils/graphics_utils.py:38-49).
- `projection`: the reference's perspective matrix
  (ref:utils/graphics_utils.py:51-71), z' = zfar*(z - znear)/(zfar -
  znear) with w' = z.
- `full_proj = projection @ world_view`.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def get_world2view(R: np.ndarray, t: np.ndarray,
                   translate=np.zeros(3), scale: float = 1.0) -> np.ndarray:
    """W2C from COLMAP-style (R, t), with optional recentring/rescaling of
    the camera center (ref:utils/graphics_utils.py:38-49)."""
    Rt = np.zeros((4, 4), np.float64)
    Rt[:3, :3] = R.transpose()
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    c2w = np.linalg.inv(Rt)
    center = (c2w[:3, 3] + translate) * scale
    c2w[:3, 3] = center
    return np.float32(np.linalg.inv(c2w))


def get_projection_matrix(znear: float, zfar: float,
                          fovx: float, fovy: float) -> np.ndarray:
    """Perspective matrix of ref:utils/graphics_utils.py:51-71."""
    tan_y = math.tan(fovy / 2)
    tan_x = math.tan(fovx / 2)
    top = tan_y * znear
    right = tan_x * znear
    P = np.zeros((4, 4), np.float32)
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def fov2focal(fov: float, pixels: int) -> float:
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal: float, pixels: int) -> float:
    return 2 * math.atan(pixels / (2 * focal))


@dataclasses.dataclass
class Camera:
    """Everything the rasterizer needs about one view, as tensors on the
    device the frame renders on."""

    world_view: torch.Tensor      # (4, 4) W2C
    full_proj: torch.Tensor       # (4, 4) projection @ W2C
    camera_center: torch.Tensor   # (3,)
    tan_fovx: torch.Tensor        # () float32
    tan_fovy: torch.Tensor        # () float32
    width: int = 0
    height: int = 0

    @property
    def focal_x(self):
        return self.width / (2.0 * self.tan_fovx)

    @property
    def focal_y(self):
        return self.height / (2.0 * self.tan_fovy)

    def to(self, device) -> "Camera":
        return dataclasses.replace(
            self, world_view=self.world_view.to(device),
            full_proj=self.full_proj.to(device),
            camera_center=self.camera_center.to(device),
            tan_fovx=self.tan_fovx.to(device),
            tan_fovy=self.tan_fovy.to(device))

    @staticmethod
    def from_Rt(R: np.ndarray, t: np.ndarray, fovx: float, fovy: float,
                width: int, height: int, znear: float = 0.01,
                zfar: float = 100.0, translate=np.zeros(3),
                scale: float = 1.0, device="cuda") -> "Camera":
        """Build from COLMAP-style extrinsics (ref:scene/cameras.py:39-48)."""
        w2c = get_world2view(R, t, translate, scale)
        proj = get_projection_matrix(znear, zfar, fovx, fovy)
        full = proj @ w2c
        center = np.linalg.inv(w2c)[:3, 3]

        def t32(a):
            return torch.as_tensor(np.float32(a), device=device)

        return Camera(world_view=t32(w2c), full_proj=t32(full),
                      camera_center=t32(center),
                      tan_fovx=t32(math.tan(fovx * 0.5)),
                      tan_fovy=t32(math.tan(fovy * 0.5)),
                      width=int(width), height=int(height))

    @staticmethod
    def look_at(eye, target, up, fovx: float, fovy: float,
                width: int, height: int, device="cuda") -> "Camera":
        """Camera at `eye` looking at `target` (x right, y down, z
        forward, the COLMAP convention)."""
        eye = np.asarray(eye, np.float64)
        target = np.asarray(target, np.float64)
        up = np.asarray(up, np.float64)
        fwd = target - eye
        fwd /= np.linalg.norm(fwd)
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        Rw2c = np.stack([right, down, fwd], axis=0)
        t = -Rw2c @ eye
        return Camera.from_Rt(Rw2c.T, t, fovx, fovy, width, height,
                              device=device)


_TENSOR_FIELDS = ("world_view", "full_proj", "camera_center", "tan_fovx",
                  "tan_fovy")


def stack_cameras(cams) -> Camera:
    """list[Camera] -> one Camera whose tensor fields gain a leading
    batch axis; the widths and heights must agree."""
    sizes = {(c.width, c.height) for c in cams}
    if len(sizes) != 1:
        raise ValueError(f"cameras of one (width, height) expected, got "
                         f"{sorted(sizes)}")
    return dataclasses.replace(cams[0], **{
        f: torch.stack([getattr(c, f) for c in cams]) for f in _TENSOR_FIELDS})


def unstack_cameras(cams) -> list:
    """A stacked Camera (stack_cameras) -> list[Camera]; a list or tuple
    of cameras is returned as a list."""
    if not isinstance(cams, Camera):
        return list(cams)
    return [dataclasses.replace(cams, **{f: getattr(cams, f)[i]
                                         for f in _TENSOR_FIELDS})
            for i in range(cams.world_view.shape[0])]


def ndc2pix(v, size):
    """NDC [-1,1] -> continuous pixel coordinate
    (ref:cuda_rasterizer/auxiliary.h:41-44)."""
    return ((v + 1.0) * size - 1.0) * 0.5


def project_points(xyz: torch.Tensor, cam: Camera):
    """Project world points: (ndc (N,3), view-space (N,3)), with the
    reference's 1e-7 w epsilon (ref:cuda_rasterizer/forward.cu:197-200)."""
    ones = torch.ones_like(xyz[..., :1])
    hom = torch.cat([xyz, ones], dim=-1)
    p_clip = hom @ cam.full_proj.T
    p_w = 1.0 / (p_clip[..., 3:4] + 1e-7)
    p_proj = p_clip[..., :3] * p_w
    p_view = hom @ cam.world_view[:3].T
    return p_proj, p_view
