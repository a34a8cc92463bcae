"""Real spherical-harmonics evaluation for view-dependent color.

Constants and basis ordering match the CUDA rasterizer
(ref:cuda_rasterizer/auxiliary.h:22-39, forward.cu:20-71).
"""

import numpy as np
import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)


def rgb_to_sh(rgb):
    """(rgb - 0.5) / C0; numpy in, numpy out, tensor in, tensor out."""
    if isinstance(rgb, np.ndarray):
        return (rgb - 0.5) / C0
    return (torch.as_tensor(rgb) - 0.5) / C0


def sh_to_rgb(sh):
    return sh * C0 + 0.5


def eval_sh(deg: int, sh, dirs):
    """Evaluate the SH basis up to `deg` (0..3).

    sh:   (..., (deg_max+1)^2, 3) coefficients; only the first (deg+1)^2
          rows are read.
    dirs: (..., 3) unit view directions.
    Returns (..., 3); the caller adds +0.5 and clamps."""
    result = C0 * sh[..., 0, :]
    if deg > 0:
        x = dirs[..., 0:1]
        y = dirs[..., 1:2]
        z = dirs[..., 2:3]
        result = (result - C1 * y * sh[..., 1, :] + C1 * z * sh[..., 2, :]
                  - C1 * x * sh[..., 3, :])
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            result = (result
                      + C2[0] * xy * sh[..., 4, :]
                      + C2[1] * yz * sh[..., 5, :]
                      + C2[2] * (2.0 * zz - xx - yy) * sh[..., 6, :]
                      + C2[3] * xz * sh[..., 7, :]
                      + C2[4] * (xx - yy) * sh[..., 8, :])
            if deg > 2:
                result = (result
                          + C3[0] * y * (3.0 * xx - yy) * sh[..., 9, :]
                          + C3[1] * xy * z * sh[..., 10, :]
                          + C3[2] * y * (4.0 * zz - xx - yy) * sh[..., 11, :]
                          + C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy)
                          * sh[..., 12, :]
                          + C3[4] * x * (4.0 * zz - xx - yy) * sh[..., 13, :]
                          + C3[5] * z * (xx - yy) * sh[..., 14, :]
                          + C3[6] * x * (xx - 3.0 * yy) * sh[..., 15, :])
    return result


def sh_to_color(deg: int, sh, xyz, campos):
    """SH -> RGB as in the rasterizer preprocess (ref:forward.cu:20-71):
    direction from the camera to the Gaussian mean, +0.5, clamp at 0."""
    dirs = xyz - campos
    dirs = dirs / torch.clamp(
        torch.linalg.norm(dirs, dim=-1, keepdim=True), min=1e-12)
    return torch.clamp(eval_sh(deg, sh, dirs) + 0.5, min=0.0)
