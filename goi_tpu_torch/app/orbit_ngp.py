"""NGP/DreamGaussian-convention camera utilities.

Counterpart of goi_tpu/app/orbit_ngp.py (the parts of
ref:gui/cam_utils_ngp.py the apps use): `orbit_pose`, a c2w from
elevation and azimuth, `look_at_rotation`, intrinsics <-> fov, and an
absolute-pose orbit camera (`set_pose`/`pose` hold a full c2w, unlike
app/orbit.py's quaternion controller) with GL perspective and mvp
matrices. Numpy only; `to_camera` builds the renderer's Camera.
"""

from __future__ import annotations

import math

import numpy as np

from goi_tpu_torch.app.orbit import gl_pose_to_camera
from goi_tpu_torch.core.camera import Camera


def _normalize(v, eps=1e-20):
    return v / max(np.linalg.norm(v), eps)


def look_at_rotation(campos, target, opengl: bool = True) -> np.ndarray:
    """(3,3) rotation whose columns are (right, up, forward);
    forward = campos-target for OpenGL (camera looks down -z), or
    target-campos otherwise (ref:gui/cam_utils_ngp.py:97-115)."""
    campos = np.asarray(campos, np.float64)
    target = np.asarray(target, np.float64)
    up = np.array([0.0, 1.0, 0.0])
    if opengl:
        fwd = _normalize(campos - target)
        right = _normalize(np.cross(up, fwd))
        up = _normalize(np.cross(fwd, right))
    else:
        fwd = _normalize(target - campos)
        right = _normalize(np.cross(fwd, up))
        up = _normalize(np.cross(right, fwd))
    return np.stack([right, up, fwd], axis=1)


def orbit_pose(elevation, azimuth, radius: float = 1.0,
               is_degree: bool = True, target=None,
               opengl: bool = True) -> np.ndarray:
    """(4,4) c2w from spherical angles: elevation in (-90, 90) from +y
    to -y, azimuth in (-180, 180] from +z to +x
    (ref:gui/cam_utils_ngp.py:118-136)."""
    if is_degree:
        elevation = math.radians(elevation)
        azimuth = math.radians(azimuth)
    x = radius * math.cos(elevation) * math.sin(azimuth)
    y = -radius * math.sin(elevation)
    z = radius * math.cos(elevation) * math.cos(azimuth)
    target = np.zeros(3) if target is None else np.asarray(target,
                                                           np.float64)
    campos = np.array([x, y, z]) + target
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = look_at_rotation(campos, target, opengl)
    T[:3, 3] = campos
    return T


def intrinsic_to_fov(f_x: float, f_y: float, width: int, height: int):
    """(fovx, fovy) radians from focals
    (ref:gui/cam_utils_ngp.py:61-77)."""
    return (2 * math.atan(width / (2 * f_x)),
            2 * math.atan(height / (2 * f_y)))


class NGPOrbitCamera:
    """Absolute-pose camera (c2w stored directly) with GL-style
    projection, the cam_utils_ngp OrbitCamera variant
    (ref:gui/cam_utils_ngp.py:138-223)."""

    def __init__(self, width: int, height: int, r: float = 2.0,
                 fovy: float = 60.0, fovx=None, near: float = 0.01,
                 far: float = 100.0):
        self.W = width
        self.H = height
        self.radius = r
        self.fovy = math.radians(fovy)
        self.fovx = math.radians(fovx) if fovx is not None else \
            2 * math.atan(math.tan(self.fovy / 2) * width / height)
        self.near = near
        self.far = far
        self.T = orbit_pose(0.0, 0.0, r)

    # ---- pose ----
    @property
    def pose(self) -> np.ndarray:
        return self.T

    def set_pose(self, c2w: np.ndarray) -> None:
        self.T = np.asarray(c2w, np.float32)

    def orbit_to(self, elevation, azimuth, radius=None, target=None):
        self.T = orbit_pose(elevation, azimuth,
                            radius if radius is not None else self.radius,
                            target=target)

    @property
    def campos(self) -> np.ndarray:
        return self.T[:3, 3]

    @property
    def view(self) -> np.ndarray:
        return np.linalg.inv(self.pose)

    # ---- projection (GL clip space, ref::196-214) ----
    @property
    def perspective(self) -> np.ndarray:
        y = math.tan(self.fovy / 2)
        aspect = self.W / self.H
        return np.array([
            [1 / (y * aspect), 0, 0, 0],
            [0, -1 / y, 0, 0],
            [0, 0, -(self.far + self.near) / (self.far - self.near),
             -(2 * self.far * self.near) / (self.far - self.near)],
            [0, 0, -1, 0]], dtype=np.float32)

    @property
    def intrinsics(self) -> np.ndarray:
        focal = self.H / (2 * math.tan(self.fovy / 2))
        return np.array([focal, focal, self.W // 2, self.H // 2],
                        np.float32)

    @property
    def mvp(self) -> np.ndarray:
        return self.perspective @ self.view

    def to_camera(self, device="cuda") -> Camera:
        """The renderer's Camera on `device`, from the OpenGL c2w (the
        y/z flip of app/orbit.py's OrbitCamera.to_camera)."""
        return gl_pose_to_camera(self.pose, self.fovx, self.fovy, self.W,
                                 self.H, self.near, self.far, device)
