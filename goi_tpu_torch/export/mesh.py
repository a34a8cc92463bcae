"""Geometry export: density grids, colored point clouds, ellipsoid
meshes.

Counterpart of goi_tpu/export/mesh.py. `density_grid` evaluates the
opacity-weighted Gaussian mixture on a regular grid; on a CUDA scene its
all-pairs sum runs in the hand-written kernel csrc/density_grid.cu
(`mixture_grid`), on a CPU scene in its plain version
`density_grid_plain`. The JAX package ran the sum in XLA over 4096-point
batches that hold (4096, N, 3) differences, which no card holds at 1M
Gaussians. The exports write the same files as the JAX package's.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import numpy as np
import torch

from goi_tpu_torch.core.scene import GaussianScene, build_rotation_matrix
from goi_tpu_torch.core.sh import sh_to_rgb
from goi_tpu_torch.raster import _nvcc

_SIGNATURES = {"goi_density_grid": [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p]}
# exp(-m / 2) = 2^(Q * m): the kernel's one special-function op a pair
Q = -0.5 / math.log(2.0)
PACK = 12   # floats a packed Gaussian (three 16-byte rows)
# pairs (points x Gaussians) of one block of the plain version: ~1 GB of
# float32 temporaries
PLAIN_PAIRS = 1 << 25


def pack_gaussians(scene: GaussianScene) -> torch.Tensor:
    """(n_valid, 12) float32 on the scene's device: mx my mz w | cxx cxy
    cyy cxz | cyz czz 0 0, with w = sigmoid(opacity) and the precision
    R diag(1 / max(s, 1e-6)^2) R^T's six entries scaled by Q (the cross
    terms by 2Q). Invalid rows carry weight 0 in the JAX package's sum
    and are left out."""
    valid = scene.valid
    mu = scene.xyz[valid]
    w = scene.get_opacity()[valid][:, 0]
    rot = build_rotation_matrix(scene.get_rotation()[valid])
    inv_s = 1.0 / torch.clamp(scene.get_scaling()[valid], min=1e-6)
    prec = torch.einsum("nik,nk,njk->nij", rot, inv_s ** 2, rot)
    zero = torch.zeros_like(w)
    return torch.stack([
        mu[:, 0], mu[:, 1], mu[:, 2], w,
        Q * prec[:, 0, 0], 2 * Q * prec[:, 0, 1], Q * prec[:, 1, 1],
        2 * Q * prec[:, 0, 2],
        2 * Q * prec[:, 1, 2], Q * prec[:, 2, 2], zero, zero], 1
    ).contiguous()


def mixture_at(packed: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """The mixture at (P, 3) points, (P,) float32: the kernel's float32
    arithmetic, one (P, N) block, summed over the Gaussians by torch."""
    g = packed[None]
    dx = points[:, 0:1] - g[..., 0]
    dy = points[:, 1:2] - g[..., 1]
    dz = points[:, 2:3] - g[..., 2]
    qa = dx * (g[..., 4] * dx + g[..., 5] * dy) + g[..., 6] * (dy * dy)
    qb = g[..., 7] * dx + g[..., 8] * dy
    q = qa + dz * (qb + g[..., 9] * dz)
    return (g[..., 3] * torch.exp2(q)).sum(1)


def grid_points(axes: torch.Tensor, k0: int, k1: int) -> torch.Tensor:
    """The points (i, j, k) of z-slabs k0..k1-1 in C order,
    (R * R * (k1 - k0), 3)."""
    gx, gy, gz = torch.meshgrid(axes, axes, axes[k0:k1], indexing="ij")
    return torch.stack([gx, gy, gz], -1).reshape(-1, 3)


def density_grid_plain(packed: torch.Tensor, axes: torch.Tensor,
                       chunk: int = 64) -> torch.Tensor:
    """The plain version of `mixture_grid`: (R, R, R) float32, in blocks
    of at most `chunk` z-slabs and PLAIN_PAIRS pairs (each point's sum
    over the Gaussians is one row's sum, so the blocks do not change it)."""
    r = axes.shape[0]
    n = max(packed.shape[0], 1)
    slabs = max(1, min(chunk, r, PLAIN_PAIRS // (n * r * r)))
    per = max(1, PLAIN_PAIRS // n)
    out = []
    for k0 in range(0, r, slabs):
        k1 = min(k0 + slabs, r)
        pts = grid_points(axes, k0, k1)
        sums = [mixture_at(packed, pts[p:p + per])
                for p in range(0, pts.shape[0], per)]
        out.append(torch.cat(sums).reshape(r, r, k1 - k0))
    return torch.cat(out, 2)


def mixture_grid(packed: torch.Tensor, axes: torch.Tensor,
                 chunk: int = 64) -> torch.Tensor:
    """packed (N, 12) float32 from `pack_gaussians`, axes (R,) float32 ->
    the mixture on the (R, R, R) grid of the axes: csrc/density_grid.cu
    on CUDA tensors, `density_grid_plain` on CPU tensors (`chunk` bounds
    its memory only)."""
    if packed.dim() != 2 or packed.shape[1] != PACK or axes.dim() != 1 \
            or axes.shape[0] == 0:
        raise ValueError(f"packed (N, {PACK}) and axes (R > 0,) expected, "
                         f"got {tuple(packed.shape)} and {tuple(axes.shape)}")
    if not _nvcc.is_cuda(packed):
        return density_grid_plain(packed, axes, chunk)
    if packed.dtype != torch.float32 or axes.dtype != torch.float32:
        raise TypeError(f"float32 packed and axes expected, got "
                        f"{packed.dtype} and {axes.dtype}")
    if not _nvcc.is_cuda(axes) or axes.device != packed.device:
        raise ValueError("packed and axes must be on the same CUDA device")
    if packed.shape[0] >= 2 ** 31:
        raise ValueError(f"at most 2^31 - 1 Gaussians, got {packed.shape[0]}")
    lib = _nvcc.library("density_grid", _SIGNATURES)
    packed = packed.contiguous()
    axes = axes.contiguous()
    r = axes.shape[0]
    grid = torch.empty((r, r, r), dtype=torch.float32, device=packed.device)
    _nvcc.check(lib.goi_density_grid(
        packed.data_ptr(), axes.data_ptr(), grid.data_ptr(),
        packed.shape[0], r, _nvcc.stream()), "density_grid")
    mixture_grid.launches += 1
    return grid


mixture_grid.launches = 0


def grid_axes(lo: float, hi: float, resolution: int) -> np.ndarray:
    """(R,) float32 cell centres from lo + voxel/2 to hi - voxel/2, the
    JAX package's `jnp.linspace` in float32 (its endpoints exactly; a
    point between may differ from XLA's by an ulp)."""
    voxel = (hi - lo) / resolution
    ends = np.float32([lo + voxel / 2, hi - voxel / 2]).astype(np.float64)
    return np.linspace(ends[0], ends[1], resolution).astype(np.float32)


def grid_bounds(scene: GaussianScene, bounds) -> Tuple[float, float]:
    """(lo, hi): `bounds`, else percentiles 1 and 99 of the valid
    positions -/+ 0.1, taken on the host as the JAX package takes them."""
    if bounds is not None:
        return bounds
    pts = scene.xyz[scene.valid].cpu().numpy()
    lo = np.percentile(pts, 1, axis=0) - 0.1
    hi = np.percentile(pts, 99, axis=0) + 0.1
    return float(lo.min()), float(hi.max())


def density_tensor(scene: GaussianScene, resolution: int = 128,
                   bounds: Optional[Tuple[float, float]] = None,
                   chunk: int = 64):
    """`density_grid` with the grid left on the scene's device."""
    lo, hi = grid_bounds(scene, bounds)
    axes = torch.as_tensor(grid_axes(lo, hi, resolution), device=scene.device)
    grid = mixture_grid(pack_gaussians(scene), axes, chunk)
    return grid, np.array([lo, lo, lo], np.float32), (hi - lo) / resolution


def density_grid(scene: GaussianScene, resolution: int = 128,
                 bounds: Optional[Tuple[float, float]] = None,
                 chunk: int = 64) -> Tuple[np.ndarray, np.ndarray, float]:
    """Evaluate the opacity-weighted Gaussian mixture on a regular grid
    on the scene's device. Returns (grid (R,R,R) float32, origin (3,),
    voxel_size)."""
    grid, origin, voxel = density_tensor(scene, resolution, bounds, chunk)
    return grid.cpu().numpy(), origin, voxel


def _dc_rgb(scene: GaussianScene, rows: np.ndarray) -> np.ndarray:
    return np.clip(sh_to_rgb(scene.features_dc[:, 0].cpu().numpy()[rows]),
                   0, 1)


def _kept(scene: GaussianScene, min_opacity: float) -> np.ndarray:
    return (scene.valid & (scene.get_opacity()[:, 0] > min_opacity)
            ).cpu().numpy()


def export_colored_point_cloud(path: str, scene: GaussianScene,
                               min_opacity: float = 0.1) -> int:
    """PLY with x/y/z + red/green/blue from the SH DC term."""
    from goi_tpu_torch.core.ply import write_ply

    valid = _kept(scene, min_opacity)
    xyz = scene.xyz.cpu().numpy()[valid]
    rgb = _dc_rgb(scene, valid)
    write_ply(path, {
        "x": xyz[:, 0].astype(np.float32),
        "y": xyz[:, 1].astype(np.float32),
        "z": xyz[:, 2].astype(np.float32),
        "red": (rgb[:, 0] * 255).astype(np.uint8),
        "green": (rgb[:, 1] * 255).astype(np.uint8),
        "blue": (rgb[:, 2] * 255).astype(np.uint8),
    })
    return int(valid.sum())


# unit octahedron template (6 verts, 8 faces)
_OCTA_V = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                    [0, 0, 1], [0, 0, -1]], np.float32)
_OCTA_F = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                    [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]])


def export_ellipsoids_obj(path: str, scene: GaussianScene,
                          min_opacity: float = 0.3, sigma: float = 1.5,
                          max_gaussians: int = 100_000) -> int:
    """OBJ of one octahedron per Gaussian, transformed by its
    covariance; the vertices on the scene's device."""
    idx = np.where(_kept(scene, min_opacity))[0][:max_gaussians]
    rows = torch.as_tensor(idx, device=scene.device)
    mu = scene.xyz[rows]
    r = build_rotation_matrix(scene.get_rotation()[rows])
    s = scene.get_scaling()[rows] * sigma
    octa = torch.as_tensor(_OCTA_V, device=scene.device)
    verts = (torch.einsum("nij,vj,nj->nvi", r, octa, s)
             + mu[:, None]).cpu().numpy()
    rgb = _dc_rgb(scene, idx)
    with open(path, "w") as f:
        f.write("# goi_tpu_torch gaussian ellipsoids\n")
        for vn, c in zip(verts.tolist(), rgb.tolist()):
            color = f"{c[0]:.3f} {c[1]:.3f} {c[2]:.3f}\n"
            for v in vn:
                f.write(f"v {v[0]:.5f} {v[1]:.5f} {v[2]:.5f} " + color)
        for n in range(len(idx)):
            base = n * 6 + 1
            for tri in _OCTA_F:
                f.write(f"f {base + tri[0]} {base + tri[1]} "
                        f"{base + tri[2]}\n")
    return len(idx)
