"""Texture baking: per-triangle UV atlas + multi-view color
back-projection, with the texels on the given device.

Counterpart of goi_tpu/export/texture.py (the reference's nvdiffrast
bake, ref:gui/main.py:606-767, done with the Gaussian renderer):

  - UV atlas: one uniform chart cell per triangle (right-triangle
    packing), host math.
  - Baking: every texel maps to a barycentric 3D point; each of the 26
    orbit views renders the Gaussian scene and texels that project onto
    a facing, depth-consistent, opaque pixel take its color. Earlier
    views win (ref:gui/main.py:717-721); within a view, of two texels
    that land on one atlas pixel the later one wins, as numpy's
    assignment orders them. The self-occlusion z-buffer is an amin
    scatter (exact in any order).
  - Inpainting: empty chart texels copy their nearest baked texel
    (ref:gui/main.py:731-752), by scipy's cKDTree on the host; of
    equidistant baked texels any may be taken.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from goi_tpu_torch.core.camera import Camera, ndc2pix, project_points
from goi_tpu_torch.export.marching import Mesh, cross_rows

# same orbit schedule as the reference (ref:gui/main.py:630-631)
_VERS = [0] * 8 + [-45] * 8 + [45] * 8 + [-89.9, 89.9]
_HORS = [0, 45, -45, 90, -90, 135, -135, 180] * 3 + [0, 0]


def _chart_layout(num_faces: int, texture_size: int, margin: float = 1.0):
    """Uniform grid of per-triangle chart cells. Returns
    (uvs (F*3, 2) in [0,1] with v up (OBJ convention),
     texel barycentrics (T, 3), texel cell offsets (T, 2) in pixels,
     cells_per_side)."""
    side = int(math.ceil(math.sqrt(num_faces)))
    cell = texture_size / side
    m = min(margin, cell / 4)
    # canonical right triangle corners inside a cell (pixel units)
    c0 = np.array([m, m])
    c1 = np.array([cell - 2 * m, m])
    c2 = np.array([m, cell - 2 * m])

    f = np.arange(num_faces)
    cx = (f % side) * cell
    cy = (f // side) * cell
    corners = np.stack([c0, c1, c2], 0)[None] \
        + np.stack([cx, cy], -1)[:, None, :]            # (F, 3, 2)
    uvs = corners.reshape(-1, 2) / texture_size
    uvs = np.stack([uvs[:, 0], 1.0 - uvs[:, 1]], -1)     # OBJ v-up

    # texels of the canonical cell that fall inside the triangle
    # (+0.75px halo so bilinear lookups at edges stay in-chart)
    g = np.arange(int(math.ceil(cell))) + 0.5
    ty, tx = np.meshgrid(g, g, indexing="ij")
    pts = np.stack([tx.ravel(), ty.ravel()], -1)          # (cell^2, 2)
    # barycentrics wrt (c0, c1, c2): affine solve
    M = np.stack([c1 - c0, c2 - c0], axis=1)             # rows
    bary12 = (pts - c0) @ np.linalg.inv(M)
    bary = np.concatenate([1 - bary12.sum(-1, keepdims=True), bary12], -1)
    halo = 0.75 / max(cell - 3 * m, 1e-6)
    keep = (bary > -halo).all(axis=1)
    return uvs, bary[keep], pts[keep], side


def bake_center_radius(vertices: np.ndarray, center=None, radius=None):
    """The orbit's centre (the vertices' box centre) and radius (2.2 x
    the farthest vertex), unless given."""
    if center is None:
        center = 0.5 * (vertices.min(0) + vertices.max(0))
    if radius is None:
        radius = 2.2 * float(np.linalg.norm(vertices - center, axis=1).max())
    return center, radius


def orbit_cameras(center, radius: float, *, render_resolution: int = 512,
                  fov: float = 0.9, device="cuda"):
    """The bake's 26 (eye, Camera) pairs, in bake order."""
    out = []
    for ver, hor in zip(_VERS, _HORS):
        va, ha = math.radians(ver), math.radians(hor)
        eye = center + radius * np.array([
            math.cos(va) * math.sin(ha),
            math.sin(va),
            -math.cos(va) * math.cos(ha)])
        out.append((eye, Camera.look_at(
            eye, center, [0, 1, 0], fovx=fov, fovy=fov,
            width=render_resolution, height=render_resolution,
            device=device)))
    return out


def _norm_rows(v: torch.Tensor) -> torch.Tensor:
    """np.linalg.norm(v, axis=1): the squares summed in column order."""
    return torch.sqrt(v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1]
                      + v[:, 2] * v[:, 2])


def _inpaint(albedo: np.ndarray, baked: np.ndarray,
             want: np.ndarray) -> None:
    """Copy into each wanted, unbaked texel its nearest baked texel."""
    hole = want & ~baked
    if hole.any() and baked.any():
        from scipy.spatial import cKDTree
        src = np.stack(np.nonzero(baked), -1)
        dst = np.stack(np.nonzero(hole), -1)
        _, idx = cKDTree(src).query(dst, k=1)
        albedo[tuple(dst.T)] = albedo[tuple(src[idx].T)]


def bake_texture(
    render_fn,
    mesh: Mesh,
    *,
    texture_size: int = 1024,
    render_resolution: int = 512,
    radius: Optional[float] = None,
    fov: float = 0.9,
    depth_tol: float = 0.02,   # relative z-buffer tolerance
    viewcos_min: float = 0.5,
    center: Optional[np.ndarray] = None,
    device="cuda",
) -> Mesh:
    """Bake an albedo texture for `mesh` by back-projecting rendered
    views. `render_fn(cam) -> dict(render (3,H,W), alpha (1,H,W), ...)`
    is any renderer honoring the render() contract on `device` (the
    cameras are built there; typically a closure over
    goi_tpu_torch.raster.render). Returns the mesh with `uvs` and
    `albedo` set."""
    dev = torch.device(device)
    v, f = mesh.vertices, mesh.faces
    center, radius = bake_center_radius(v, center, radius)

    uvs, bary, cell_pts, side = _chart_layout(len(f), texture_size)
    cell = texture_size / side
    n_tex = bary.shape[0]

    # texel world positions + normals
    tri = torch.as_tensor(v[f], device=dev)                       # (F, 3, 3)
    pos = torch.einsum("tb,fbc->ftc", torch.as_tensor(bary, device=dev),
                       tri.to(torch.float64))
    n = cross_rows(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    n = n / torch.clamp(_norm_rows(n), min=1e-12)[:, None]

    # texel pixel coords in the atlas (host math, as the JAX package's)
    fx = (np.arange(len(f)) % side) * cell
    fy = (np.arange(len(f)) // side) * cell
    px = np.clip((fx[:, None] + cell_pts[None, :, 0]).astype(np.int64), 0,
                 texture_size - 1)
    py = np.clip((fy[:, None] + cell_pts[None, :, 1]).astype(np.int64), 0,
                 texture_size - 1)
    key = torch.as_tensor((py * texture_size + px).reshape(-1), device=dev)

    albedo = torch.zeros((texture_size * texture_size, 3),
                         dtype=torch.float32, device=dev)
    baked = torch.zeros(texture_size * texture_size, dtype=torch.bool,
                        device=dev)
    winner = torch.empty(texture_size * texture_size, dtype=torch.int64,
                         device=dev)

    flat_pos = pos.reshape(-1, 3)
    pos32 = flat_pos.to(torch.float32)
    flat_n = n.repeat_interleave(n_tex, 0).to(torch.float64)
    order = torch.arange(flat_pos.shape[0], device=dev)
    rr = render_resolution
    for eye, cam in orbit_cameras(center, radius, render_resolution=rr,
                                  fov=fov, device=dev):
        out = render_fn(cam)
        img = out["render"]                                  # (3, H, W)
        alp = out["alpha"][0]

        # project texels (float32, as the JAX package projects them)
        p_proj, p_view = project_points(pos32, cam)
        sx = ndc2pix(p_proj[:, 0], rr)
        sy = ndc2pix(p_proj[:, 1], rr)
        z = p_view[:, 2]
        ix = torch.round(sx).to(torch.int64)
        iy = torch.round(sy).to(torch.int64)
        inb = (ix >= 0) & (ix < rr) & (iy >= 0) & (iy < rr) & (z > 0.2)
        ix_c = ix.clamp(0, rr - 1)
        iy_c = iy.clamp(0, rr - 1)

        viewdir = torch.as_tensor(eye, device=dev)[None] - flat_pos
        viewdir = viewdir / torch.clamp(_norm_rows(viewdir),
                                        min=1e-12)[:, None]
        cosv = flat_n * viewdir
        facing = (cosv[:, 0] + cosv[:, 1] + cosv[:, 2]) > viewcos_min
        solid = alp[iy_c, ix_c] > 0.5
        # self-occlusion: z-buffer built from the projected texels
        # themselves (the software analog of the reference's nvdiffrast
        # mesh rasterization gate, ref:gui/main.py:682-702)
        pid = iy_c * rr + ix_c
        z64 = z.to(torch.float64)
        zbuf = torch.full((rr * rr,), math.inf, dtype=torch.float64,
                          device=dev)
        front = inb & facing
        zbuf.scatter_reduce_(0, pid[front], z64[front], "amin")
        vis = z64 <= zbuf[pid] * (1.0 + depth_tol)
        fresh = inb & facing & solid & vis & ~baked[key]
        # of the fresh texels on one atlas pixel, the last one wins
        idx = order[fresh]
        winner.fill_(-1)
        winner.scatter_reduce_(0, key[idx], idx, "amax")
        idx = idx[winner[key[idx]] == idx]
        albedo[key[idx]] = img[:, iy_c[idx], ix_c[idx]].T
        baked[key[idx]] = True

    albedo_np = albedo.reshape(texture_size, texture_size, 3).cpu().numpy()
    want = np.zeros((texture_size, texture_size), bool)
    want[py.reshape(-1), px.reshape(-1)] = True
    _inpaint(albedo_np, baked.reshape(texture_size, texture_size)
             .cpu().numpy(), want)
    mesh.uvs = uvs.astype(np.float32)
    mesh.albedo = albedo_np
    return mesh


def extract_textured_mesh(scene, bg, config, *,
                          density_thresh: float = 1.0,
                          resolution: int = 128,
                          texture_size: int = 1024,
                          **bake_kw) -> Mesh:
    """One-call scene -> textured mesh on the scene's device (the
    reference's 'geo+tex' save mode, ref:gui/main.py:609-755)."""
    from goi_tpu_torch.export.marching import extract_mesh
    from goi_tpu_torch.raster.render import render

    mesh = extract_mesh(scene, density_thresh=density_thresh,
                        resolution=resolution)

    def fn(cam):
        with torch.no_grad():
            return render(scene, cam, bg, config)

    return bake_texture(fn, mesh, texture_size=texture_size,
                        device=scene.device, **bake_kw)
