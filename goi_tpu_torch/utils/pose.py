"""Camera-pose interpolation for smooth video paths.

Counterpart of goi_tpu/utils/pose.py (the role of
ref:utils/camera_utils.py:152-186): quaternion slerp between anchor
poses and linear interpolation of their positions. Numpy only.
"""

from __future__ import annotations

from typing import List

import numpy as np

from goi_tpu_torch.data.colmap import qvec2rotmat, rotmat2qvec


def slerp(q0: np.ndarray, q1: np.ndarray, t: float) -> np.ndarray:
    """Spherical linear interpolation of (w, x, y, z) quaternions."""
    q0 = q0 / np.linalg.norm(q0)
    q1 = q1 / np.linalg.norm(q1)
    dot = float(np.dot(q0, q1))
    if dot < 0.0:
        q1, dot = -q1, -dot
    if dot > 0.9995:
        out = q0 + t * (q1 - q0)
        return out / np.linalg.norm(out)
    theta0 = np.arccos(np.clip(dot, -1, 1))
    theta = theta0 * t
    s0 = np.cos(theta) - dot * np.sin(theta) / np.sin(theta0)
    s1 = np.sin(theta) / np.sin(theta0)
    return s0 * q0 + s1 * q1


def interpolate_poses(c2ws: List[np.ndarray], steps_per_segment: int = 30
                      ) -> List[np.ndarray]:
    """A smooth path through 4x4 camera-to-world anchor poses: each
    segment's `steps_per_segment` poses (slerp rotation, lerp
    translation), then the last anchor."""
    out = []
    for a, b in zip(c2ws[:-1], c2ws[1:]):
        qa = rotmat2qvec(a[:3, :3])
        qb = rotmat2qvec(b[:3, :3])
        for s in range(steps_per_segment):
            t = s / steps_per_segment
            m = np.eye(4)
            m[:3, :3] = qvec2rotmat(slerp(qa, qb, t))
            m[:3, 3] = (1 - t) * a[:3, 3] + t * b[:3, 3]
            out.append(m)
    out.append(c2ws[-1].copy())
    return out
