"""Orbit camera controller for interactive viewing.

Counterpart of goi_tpu/app/orbit.py (the role of ref:gui/cam_utils.py:
146-258 OrbitCamera): drag-orbit, pan, scroll-zoom, pose import, the
NeRF/OpenGL c2w convention, with the quaternion algebra inline. Numpy
only; `to_camera` builds the renderer's Camera on a device.
"""

from __future__ import annotations

import numpy as np

from goi_tpu_torch.core.camera import Camera
from goi_tpu_torch.data.colmap import qvec2rotmat, rotmat2qvec


def _quat_mul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])


def _from_rotvec(v):
    angle = np.linalg.norm(v)
    if angle < 1e-12:
        return np.array([1.0, 0, 0, 0])
    axis = v / angle
    return np.concatenate([[np.cos(angle / 2)],
                           np.sin(angle / 2) * axis])


class OrbitCamera:
    def __init__(self, width: int, height: int, r: float = 1.0,
                 fovy: float = 60.0, fovx: float | None = None,
                 near: float = 0.01, far: float = 100.0):
        self.W = width
        self.H = height
        self.radius = r
        self.fovy = np.deg2rad(fovy)
        self.fovx = (np.deg2rad(fovx) if fovx is not None else
                     2 * np.arctan(np.tan(self.fovy / 2) * width / height))
        self.near = near
        self.far = far
        self.center = np.zeros(3, np.float32)
        self.quat = np.array([1.0, 0, 0, 0])  # (w,x,y,z)

    @property
    def rotmat(self) -> np.ndarray:
        return qvec2rotmat(self.quat)

    @property
    def pose(self) -> np.ndarray:
        """c2w, OpenGL convention (camera at +radius on its z axis,
        ref:cam_utils.py:170-180)."""
        res = np.eye(4, dtype=np.float32)
        res[2, 3] = self.radius
        rot = np.eye(4, dtype=np.float32)
        rot[:3, :3] = self.rotmat
        res = rot @ res
        res[:3, 3] -= self.center
        return res

    @property
    def campos(self) -> np.ndarray:
        return self.pose[:3, 3]

    @property
    def view(self) -> np.ndarray:
        return np.linalg.inv(self.pose)

    def orbit(self, dx: float, dy: float, dz: float = 0.0) -> None:
        """(ref:cam_utils.py:223-233)."""
        rx = _from_rotvec(np.array([1, 0, 0]) * np.radians(-1.5 * dy))
        ry = _from_rotvec(np.array([0, 1, 0]) * np.radians(-1.5 * dx))
        rz = _from_rotvec(np.array([0, 0, 1]) * np.radians(dz))
        d = _quat_mul(_quat_mul(rz, ry), rx)
        self.quat = _quat_mul(self.quat, d)
        self.quat /= np.linalg.norm(self.quat)

    def scale(self, delta: float) -> None:
        if self.radius == 0:
            self.radius = 1
        self.radius *= 1.1 ** (-delta)

    def pan(self, dx: float, dy: float, dz: float = 0.0) -> None:
        self.center += 0.0005 * self.rotmat @ np.array([-dx, -dy, dz])

    def import_pose(self, c2w: np.ndarray) -> None:
        """(ref:cam_utils.py:245-252)."""
        self.center = -c2w[:3, 3]
        self.quat = rotmat2qvec(c2w[:3, :3])
        self.radius = 0.0

    def to_camera(self, device="cuda") -> Camera:
        """The renderer's Camera on `device`. Converts the OpenGL/NeRF
        c2w (Y up, Z back) to COLMAP (Y down, Z forward), the flip the
        readers apply (ref:scene/dataset_readers.py:197-199)."""
        return gl_pose_to_camera(self.pose, self.fovx, self.fovy, self.W,
                                 self.H, self.near, self.far, device)


def gl_pose_to_camera(pose, fovx, fovy, width, height, near, far,
                      device) -> Camera:
    """Camera of an OpenGL c2w: Y and Z flipped to COLMAP's, inverted."""
    c2w = np.asarray(pose, np.float64).copy()
    c2w[:3, 1:3] *= -1
    w2c = np.linalg.inv(c2w)
    return Camera.from_Rt(w2c[:3, :3].T, w2c[:3, 3], fovx, fovy, width,
                          height, znear=near, zfar=far, device=device)
