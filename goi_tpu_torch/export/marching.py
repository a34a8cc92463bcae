"""Isosurface extraction: vectorized marching tetrahedra, in torch on the
grid's device.

Counterpart of goi_tpu/export/marching.py, the same vertices and faces
bit for bit: each cell splits into 6 tets sharing the cube's main
diagonal, whose 16 sign cases reduce to 3 canonical configurations;
corner values and positions in float64, each tet's corners ordered
inside-first by a stable sort, every edge interpolated as separate
float64 operations (so one edge gives the same bits from every tet and
the exact dedup by `torch.unique` merges them), triangles oriented
toward the lower density by the grid's central-difference gradient.
Only the cells whose corners mix signs are ever expanded to their 8
corners.

`Mesh` is the host-side result (numpy arrays) with the JAX package's
writers: the OBJ/MTL text is the same bytes, the albedo PNG is written
with PIL (the same pixels), the PLY through the port's `core/ply.py`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch

# Cube corner k has offsets ((k>>0)&1, (k>>1)&1, (k>>2)&1).
_CUBE_OFFSETS = np.array(
    [[(k >> 0) & 1, (k >> 1) & 1, (k >> 2) & 1] for k in range(8)],
    np.int64)


def _cube_tets() -> np.ndarray:
    """Six tets tiling the cube, all sharing the 0-7 main diagonal: the
    outer corners 1-3-2-6-4-5 form a closed edge path around it; each
    consecutive pair + the diagonal is one tet."""
    path = [1, 3, 2, 6, 4, 5]
    return np.array([[0, 7, path[i], path[(i + 1) % 6]]
                     for i in range(6)], np.int64)


@dataclasses.dataclass
class Mesh:
    """Minimal triangle-mesh container, host arrays."""

    vertices: np.ndarray          # (V, 3) float32
    faces: np.ndarray             # (F, 3) int64
    uvs: Optional[np.ndarray] = None        # (F*3, 2) per-corner UV
    albedo: Optional[np.ndarray] = None     # (H, W, 3) float [0,1]

    def compute_normals(self) -> np.ndarray:
        """Area-weighted vertex normals, summed on the host in face order
        (np.add.at), as the JAX package sums them."""
        v = self.vertices
        f = self.faces
        n = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
        vn = np.zeros_like(v)
        np.add.at(vn, f[:, 0], n)
        np.add.at(vn, f[:, 1], n)
        np.add.at(vn, f[:, 2], n)
        return vn / np.maximum(np.linalg.norm(vn, axis=1, keepdims=True),
                               1e-12)

    def write_obj(self, path: str, write_texture: bool = True) -> None:
        """OBJ (+ MTL + PNG albedo when baked), loadable in any DCC
        tool."""
        base = os.path.splitext(path)[0]
        name = os.path.basename(base)
        textured = self.albedo is not None and write_texture
        with open(path, "w") as f:
            if textured:
                f.write(f"mtllib {name}.mtl\n")
            for v in self.vertices.tolist():
                f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
            if self.uvs is not None:
                for uv in self.uvs.tolist():
                    f.write(f"vt {uv[0]:.6f} {uv[1]:.6f}\n")
                f.write(f"usemtl {name}\n")
                for i, (a, b, c) in enumerate((self.faces + 1).tolist()):
                    f.write(f"f {a}/{3 * i + 1} {b}/{3 * i + 2} "
                            f"{c}/{3 * i + 3}\n")
            else:
                for a, b, c in (self.faces + 1).tolist():
                    f.write(f"f {a} {b} {c}\n")
        if textured:
            from PIL import Image
            Image.fromarray(
                (np.clip(self.albedo, 0, 1) * 255).astype(np.uint8)
            ).save(base + ".png")
            with open(base + ".mtl", "w") as f:
                f.write(f"newmtl {name}\nKd 1 1 1\nmap_Kd {name}.png\n")

    def write_ply(self, path: str) -> None:
        from goi_tpu_torch.core.ply import write_ply
        write_ply(path, {
            "x": self.vertices[:, 0].astype(np.float32),
            "y": self.vertices[:, 1].astype(np.float32),
            "z": self.vertices[:, 2].astype(np.float32),
        }, faces=self.faces)


def _mixed_cells(inside: torch.Tensor) -> torch.Tensor:
    """(C, 3) int64 origins, in C order, of the cells whose 8 corners
    are neither all inside nor all outside."""
    rx, ry, rz = inside.shape
    any_in = torch.zeros((rx - 1, ry - 1, rz - 1), dtype=torch.bool,
                         device=inside.device)
    all_in = torch.ones_like(any_in)
    for di, dj, dk in _CUBE_OFFSETS.tolist():
        corner = inside[di:di + rx - 1, dj:dj + ry - 1, dk:dk + rz - 1]
        any_in |= corner
        all_in &= corner
    return torch.nonzero(any_in & ~all_in)


def _edge_point(vals, pos, ia, ib, iso):
    """float64 interpolation of each row's edge (ia, ib), each operation
    rounded on its own: the same bits for one edge from any tet."""
    va, vb = vals[:, ia], vals[:, ib]
    w = (iso - va) / (vb - va)
    pa = pos[:, ia]
    return pa + w[:, None] * (pos[:, ib] - pa)


def cross_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """np.cross of rows, each product and difference rounded on its own."""
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], 1)


def _gradient_at(grid64: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """np.gradient(grid64) (unit spacing, first-order edges) at (F, 3)
    grid indices, (F, 3)."""
    out = []
    for ax in range(3):
        n = grid64.shape[ax]
        lo, hi = idx.clone(), idx.clone()
        lo[:, ax] = (idx[:, ax] - 1).clamp(min=0)
        hi[:, ax] = (idx[:, ax] + 1).clamp(max=n - 1)
        diff = (grid64[hi[:, 0], hi[:, 1], hi[:, 2]]
                - grid64[lo[:, 0], lo[:, 1], lo[:, 2]])
        out.append(diff / (hi[:, ax] - lo[:, ax]).to(torch.float64))
    return torch.stack(out, 1)


def marching_tetrahedra(grid, iso: float, origin=(0.0, 0.0, 0.0),
                        voxel: float = 1.0) -> Mesh:
    """Extract the iso-surface of a (Rx, Ry, Rz) scalar grid (a float32
    numpy array, or a tensor: the work runs on its device).

    Returns a Mesh in world coordinates (origin + voxel * index),
    vertices deduplicated, triangle normals oriented outward (from
    values > iso toward values < iso)."""
    grid = torch.as_tensor(grid)
    dev = grid.device
    inside = grid > iso
    corner_idx = (_mixed_cells(inside)[:, None, :]
                  + torch.as_tensor(_CUBE_OFFSETS, device=dev)[None])
    corner_val = grid[corner_idx[..., 0], corner_idx[..., 1],
                      corner_idx[..., 2]].to(torch.float64)       # (C, 8)
    corner_pos = corner_idx.to(torch.float64)                     # (C, 8, 3)

    tris = []
    for v_ids in _cube_tets().tolist():
        vals = corner_val[:, v_ids]                               # (C, 4)
        ins = vals > iso
        k = ins.sum(1)
        # canonical ordering: inside vertices first (stable sort)
        order = torch.argsort((~ins).to(torch.uint8), dim=1, stable=True)
        vals_s = torch.gather(vals, 1, order)
        pos_s = torch.gather(corner_pos[:, v_ids], 1,
                             order[..., None].expand(-1, -1, 3))

        def edges(sel, *pairs):
            v, p = vals_s[sel], pos_s[sel]
            return [_edge_point(v, p, a, b, iso) for a, b in pairs]

        # k == 1: triangle (a-b, a-c, a-d), a inside
        sel = k == 1
        if sel.any():
            tris.append(torch.stack(edges(sel, (0, 1), (0, 2), (0, 3)), 1))
        # k == 3: triangle (a-d, b-d, c-d), d outside
        sel = k == 3
        if sel.any():
            tris.append(torch.stack(edges(sel, (0, 3), (1, 3), (2, 3)), 1))
        # k == 2: quad (a-c, a-d, b-d, b-c) -> two triangles
        sel = k == 2
        if sel.any():
            p_ac, p_ad, p_bd, p_bc = edges(sel, (0, 2), (0, 3), (1, 3),
                                           (1, 2))
            tris.append(torch.stack([p_ac, p_ad, p_bd], 1))
            tris.append(torch.stack([p_ac, p_bd, p_bc], 1))

    if not tris:
        return Mesh(np.zeros((0, 3), np.float32),
                    np.zeros((0, 3), np.int64))
    tri = torch.cat(tris)                                         # (F, 3, 3)

    # orient: the normal must point toward the OUTSIDE (decreasing
    # density); the density gradient at the centroid's grid point points
    # inward, so flip the triangles whose normal agrees with it
    centroid = (tri[:, 0] + tri[:, 1] + tri[:, 2]) / 3.0
    upper = torch.as_tensor(grid.shape, device=dev) - 1
    gi = torch.minimum(torch.round(centroid).to(torch.int64).clamp(min=0),
                       upper)
    grad = _gradient_at(grid.to(torch.float64), gi)
    n = cross_rows(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    p = n * grad
    flip = (p[:, 0] + p[:, 1] + p[:, 2]) > 0
    tri[flip] = tri[flip].flip(1)

    # dedup vertices (exact: edge interpolations of the same edge are
    # bitwise equal in float64); rows sorted as np.unique sorts them
    uniq, inv = torch.unique(tri.reshape(-1, 3), dim=0, return_inverse=True)
    faces = inv.reshape(-1, 3)
    # drop degenerate triangles (tet faces lying in the iso-surface)
    ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
          & (faces[:, 0] != faces[:, 2]))
    verts = (torch.as_tensor(np.asarray(origin, np.float64), device=dev)[None]
             + uniq * float(voxel)).to(torch.float32)
    return Mesh(verts.cpu().numpy(), faces[ok].cpu().numpy())


def extract_mesh(scene, density_thresh: float = 1.0,
                 resolution: int = 128,
                 bounds: Optional[Tuple[float, float]] = None) -> Mesh:
    """Gaussian scene -> density grid -> iso-surface mesh, on the
    scene's device (the role of the reference's
    gaussians.extract_mesh(path, density_thresh))."""
    from goi_tpu_torch.export.mesh import density_tensor

    grid, origin, voxel = density_tensor(scene, resolution=resolution,
                                         bounds=bounds)
    return marching_tetrahedra(grid, density_thresh, origin, voxel)
