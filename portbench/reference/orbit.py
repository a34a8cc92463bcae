"""The viewer's camera of an orbit request (elev, azim, radius, w, h,
scale), as the reference GUI's NGP orbit camera defines it
(ref:gui/cam_utils_ngp.py:97-223): 16-pixel-aligned size, vertical
field of view `fovy_deg`, an OpenGL camera-to-world pose on the sphere
around the origin, turned into COLMAP's convention (y and z flipped)."""

from __future__ import annotations

import math

import numpy as np

from portbench import inputs


def _unit(v):
    return v / max(np.linalg.norm(v), 1e-20)


def viewer_camera(q: dict, fovy_deg: float) -> dict:
    sc = float(q.get("scale", 1.0))
    w = max(16, int(round(int(q["w"]) * sc / 16)) * 16)
    h = max(16, int(round(int(q["h"]) * sc / 16)) * 16)
    fovy = math.radians(fovy_deg)
    fovx = 2 * math.atan(math.tan(fovy / 2) * w / h)
    el, az, r = math.radians(q["elev"]), math.radians(q["azim"]), q["radius"]
    pos = np.array([r * math.cos(el) * math.sin(az), -r * math.sin(el),
                    r * math.cos(el) * math.cos(az)])
    fwd = _unit(pos)
    right = _unit(np.cross([0.0, 1.0, 0.0], fwd))
    up = _unit(np.cross(fwd, right))
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.stack([right, up, fwd], axis=1)
    c2w[:3, 3] = pos
    c2w = c2w.astype(np.float64)
    c2w[:3, 1:3] *= -1
    return inputs.camera(np.linalg.inv(c2w), fovx, fovy, w, h, 0.01, 100.0)
