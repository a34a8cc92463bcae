"""goi_tpu_torch.export against goi_tpu.export on the CPU: the density
grid, marching tetrahedra, the Mesh writers and the two direct exports,
on the same seeded inputs in both packages.

Tolerances: the density grid within 1e-5 of the grid's peak (float32
sums of the same terms in another order, `exp2` of a pre-scaled form
against `exp`; the axes may differ from `jnp.linspace`'s by an ulp); on
the anisotropic scene (aspect ratios to 60:1, precisions to 6e4) 3e-5,
because there each float32 evaluation is itself ~1e-5 of the peak off a
float64 one (`test_density_grid_plain_matches_float64` shows the
port's). Marching tetrahedra, the OBJ/MTL/PLY bytes, the PNG pixels and
the point cloud exactly; the ellipsoid OBJ's face lines exactly and its
numbers within 1e-5 (`.5f` of an einsum taken in another order)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goi_tpu.export import marching as jmarch
from goi_tpu.export import mesh as jmesh
from goi_tpu_torch.export import marching as tmarch
from goi_tpu_torch.export import mesh as tmesh
from tests.conftest import make_random_scene
from tests.test_mesh_export import _sphere_grid
from tests.test_torch_core import to_torch_scene

torch.set_num_threads(1)

GRID_TOL = 1e-5
ANISO_TOL = 3e-5


def _opaque(scene, logit):
    return scene.replace(opacity=jnp.full_like(scene.opacity, logit))


# (make_random_scene kwargs, bounds, resolution, chunk, tolerance); the
# JAX package's chunk divides the resolution (see ROADMAP: a chunk that
# does not reads clamped z-slabs there)
DENSITY_CASES = {
    "bounds": (dict(n=20, seed=0, spread=0.5), (-1.5, 1.5), 32, 16,
               GRID_TOL),
    "percentiles": (dict(n=300, seed=1), None, 24, 8, GRID_TOL),
    "capacity": (dict(n=150, seed=3, capacity=200), None, 16, 16, GRID_TOL),
    "anisotropic": (dict(n=200, seed=2, capacity=260, anisotropic=True),
                    None, 20, 4, ANISO_TOL),
}


@pytest.mark.parametrize("case", list(DENSITY_CASES))
def test_density_grid_matches_goi_tpu(case):
    kw, bounds, res, chunk, tol = DENSITY_CASES[case]
    js = make_random_scene(**kw)
    want, w_origin, w_voxel = jmesh.density_grid(js, resolution=res,
                                                 bounds=bounds, chunk=chunk)
    before = tmesh.mixture_grid.launches
    got, origin, voxel = tmesh.density_grid(to_torch_scene(js),
                                            resolution=res, bounds=bounds,
                                            chunk=chunk)
    assert tmesh.mixture_grid.launches == before   # CPU: plain version
    assert got.shape == (res, res, res) and got.dtype == np.float32
    np.testing.assert_array_equal(origin, w_origin)
    assert voxel == w_voxel
    assert np.abs(got - want).max() <= tol * want.max()
    assert want.max() > 0.5


def test_density_grid_peaks_at_gaussians():
    """tests/test_export_misc.py's density check, on the port."""
    ts = to_torch_scene(_opaque(make_random_scene(n=20, seed=0, spread=0.5),
                                4.0))
    grid, origin, voxel = tmesh.density_grid(ts, resolution=32, chunk=16,
                                             bounds=(-1.5, 1.5))
    assert grid.shape == (32, 32, 32)
    assert grid.max() > 0.5
    mu = ts.xyz[0].numpy()
    ijk = np.clip(((mu - origin) / voxel).astype(int), 0, 31)
    assert grid[tuple(ijk)] > grid[0, 0, 0]


def _density_float64(scene, axes):
    """The mixture from the scene's fields in float64, by the JAX
    package's formula (full 3x3 form, exp)."""
    valid = scene.valid.numpy()
    mu = scene.xyz.numpy()[valid].astype(np.float64)
    q = scene.rotation.numpy()[valid].astype(np.float64)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    r, x, y, z = q.T
    rot = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z),
                  2 * (x * z + r * y)], -1),
        np.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - r * x)], -1),
        np.stack([2 * (x * z - r * y), 2 * (y * z + r * x),
                  1 - 2 * (x * x + y * y)], -1)], -2)
    inv_s = 1.0 / np.maximum(np.exp(scene.scaling.numpy()[valid]
                                    .astype(np.float64)), 1e-6)
    prec = np.einsum("nik,nk,njk->nij", rot, inv_s ** 2, rot)
    w = 1.0 / (1.0 + np.exp(-scene.opacity.numpy()[valid, 0]
                            .astype(np.float64)))
    ax = axes.astype(np.float64)
    pts = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
    d = pts[:, None] - mu[None]
    m = np.einsum("pni,nij,pnj->pn", d, prec, d)
    return (w * np.exp(-0.5 * m)).sum(1).reshape(len(ax), len(ax), len(ax))


@pytest.mark.parametrize("case", ["bounds", "capacity", "anisotropic"])
def test_density_grid_plain_matches_float64(case):
    kw, bounds, res, _, tol = DENSITY_CASES[case]
    ts = to_torch_scene(make_random_scene(**kw))
    lo, hi = tmesh.grid_bounds(ts, bounds)
    axes = tmesh.grid_axes(lo, hi, res)
    want = _density_float64(ts, axes)
    got = tmesh.density_grid_plain(tmesh.pack_gaussians(ts),
                                   torch.as_tensor(axes))
    assert np.abs(got.numpy() - want).max() <= tol * want.max()


def test_density_grid_blocks_do_not_change_the_grid(monkeypatch):
    """`chunk` and the pair budget bound the plain version's memory
    only: the same bits at any block size, chunks that do not divide the
    resolution included."""
    ts = to_torch_scene(make_random_scene(n=120, seed=4))
    want, _, _ = tmesh.density_grid(ts, resolution=18)
    for chunk in (1, 5, 7, 18):
        got, _, _ = tmesh.density_grid(ts, resolution=18, chunk=chunk)
        np.testing.assert_array_equal(got, want)
    monkeypatch.setattr(tmesh, "PLAIN_PAIRS", 1000)
    got, _, _ = tmesh.density_grid(ts, resolution=18, chunk=3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lo,hi,res", [(-1.5, 1.5, 32), (-0.83, 1.27, 128),
                                       (0.2, 0.9, 1), (-2.0, 3.0, 2)])
def test_grid_axes_match_jnp_linspace(lo, hi, res):
    """The same endpoints as jnp.linspace in float32 and every point
    within one ulp of the larger endpoint."""
    voxel = (hi - lo) / res
    want = np.asarray(jnp.linspace(lo + voxel / 2, hi - voxel / 2, res))
    got = tmesh.grid_axes(lo, hi, res)
    assert got.dtype == np.float32 and got.shape == (res,)
    assert got[0] == want[0] and got[-1] == want[-1]
    ulp = np.spacing(np.float32(max(abs(lo), abs(hi))))
    assert np.abs(got - want).max() <= ulp


def _same_mesh(a, b):
    np.testing.assert_array_equal(a.vertices, b.vertices)
    np.testing.assert_array_equal(a.faces, b.faces)
    assert a.vertices.dtype == b.vertices.dtype == np.float32
    assert a.faces.dtype == b.faces.dtype == np.int64


@pytest.mark.parametrize("iso,res", [(0.0, 40), (0.3, 24)])
def test_marching_tetrahedra_sphere_matches_goi_tpu(iso, res):
    """Equal vertices and faces to goi_tpu's, plus
    tests/test_mesh_export.py's watertight, Euler, orientation and area
    checks on the port's mesh."""
    grid, voxel = _sphere_grid(res=res)
    want = jmarch.marching_tetrahedra(grid, iso, origin=(-1.0, -1.0, -1.0),
                                      voxel=voxel)
    mesh = tmarch.marching_tetrahedra(grid, iso, origin=(-1.0, -1.0, -1.0),
                                      voxel=voxel)
    _same_mesh(mesh, want)
    v, f = mesh.vertices, mesh.faces
    radius = 0.7 * (1 - iso)
    assert len(f) > 500
    assert np.abs(np.linalg.norm(v, axis=1) - radius).max() < voxel
    edges = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]],
                                    f[:, [2, 0]]]), axis=1)
    uniq, counts = np.unique(edges, axis=0, return_counts=True)
    assert (counts == 2).all()
    assert len(v) - len(uniq) + len(f) == 2
    tri = v[f]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    assert ((n * tri.mean(axis=1)).sum(1) > 0).mean() > 0.99
    area = 0.5 * np.linalg.norm(n, axis=1).sum()
    assert abs(area / (4 * np.pi * radius ** 2) - 1) < 0.05


def test_marching_tetrahedra_noise_and_tensor_grid_match_goi_tpu():
    """A noisy grid (every sign case, many degenerate faces) and a
    density grid, given as numpy and as a tensor."""
    rng = np.random.default_rng(0)
    noise = rng.normal(0, 1, (13, 14, 15)).astype(np.float32)
    want = jmarch.marching_tetrahedra(noise, 0.2, origin=(0.5, -1, 2),
                                      voxel=0.37)
    _same_mesh(tmarch.marching_tetrahedra(noise, 0.2, origin=(0.5, -1, 2),
                                          voxel=0.37), want)
    _same_mesh(tmarch.marching_tetrahedra(torch.as_tensor(noise), 0.2,
                                          origin=(0.5, -1, 2), voxel=0.37),
               want)
    ts = to_torch_scene(_opaque(make_random_scene(n=40, seed=5, spread=0.4),
                                3.0))
    grid, origin, voxel = tmesh.density_grid(ts, resolution=24)
    want = jmarch.marching_tetrahedra(grid, 0.5, origin, voxel)
    assert len(want.faces) > 100
    _same_mesh(tmarch.extract_mesh(ts, density_thresh=0.5, resolution=24),
               want)
    empty = tmarch.marching_tetrahedra(np.zeros((4, 4, 4), np.float32), 1.0)
    assert empty.vertices.shape == (0, 3) and empty.faces.shape == (0, 3)


def _textured(mesh_mod):
    grid, voxel = _sphere_grid(res=12)
    mesh = mesh_mod.marching_tetrahedra(grid, 0.0, origin=(-1, -1, -1),
                                        voxel=voxel)
    rng = np.random.default_rng(7)
    mesh.uvs = rng.uniform(0, 1, (3 * len(mesh.faces), 2)).astype(np.float32)
    mesh.albedo = rng.uniform(-0.2, 1.2, (16, 24, 3)).astype(np.float32)
    return mesh


def test_mesh_writers_match_goi_tpu(tmp_path):
    """OBJ and MTL byte-identical, PNG pixels equal, PLY byte-identical,
    the normals equal; the untextured OBJ too."""
    from PIL import Image
    meshes = {"j": _textured(jmarch), "t": _textured(tmarch)}
    out = {}
    for k, mesh in meshes.items():
        d = tmp_path / k
        d.mkdir()
        mesh.write_obj(str(d / "m.obj"))
        mesh.write_ply(str(d / "m.ply"))
        mesh.write_obj(str(d / "plain.obj"), write_texture=False)
        out[k] = d
    for name in ("m.obj", "m.mtl", "m.ply", "plain.obj"):
        assert (out["t"] / name).read_bytes() == (out["j"] / name).read_bytes()
    assert not (out["t"] / "plain.mtl").exists()
    np.testing.assert_array_equal(np.asarray(Image.open(out["t"] / "m.png")),
                                  np.asarray(Image.open(out["j"] / "m.png")))
    np.testing.assert_array_equal(meshes["t"].compute_normals(),
                                  meshes["j"].compute_normals())
    bare = tmarch.Mesh(meshes["t"].vertices, meshes["t"].faces)
    bare.write_obj(str(tmp_path / "bare.obj"))
    jbare = jmarch.Mesh(meshes["j"].vertices, meshes["j"].faces)
    jbare.write_obj(str(tmp_path / "jbare.obj"))
    assert (tmp_path / "bare.obj").read_bytes() == \
        (tmp_path / "jbare.obj").read_bytes()


def _numbers(line):
    return [float(x) for x in line.split()[1:]]


def test_point_cloud_and_ellipsoids_match_goi_tpu(tmp_path):
    from goi_tpu_torch.core.ply import read_ply
    js = _opaque(make_random_scene(n=50, seed=1), 2.0)
    js = js.replace(opacity=js.opacity.at[:7].set(-3.0))
    ts = to_torch_scene(js)
    for kw in (dict(), dict(min_opacity=0.5)):
        n_t = tmesh.export_colored_point_cloud(str(tmp_path / "t.ply"), ts,
                                               **kw)
        n_j = jmesh.export_colored_point_cloud(str(tmp_path / "j.ply"), js,
                                               **kw)
        assert n_t == n_j
        assert (tmp_path / "t.ply").read_bytes() == \
            (tmp_path / "j.ply").read_bytes()
    assert n_t == 43 and len(read_ply(str(tmp_path / "t.ply"))["x"]) == 43

    for kw in (dict(min_opacity=0.5), dict(max_gaussians=20, sigma=2.0)):
        m_t = tmesh.export_ellipsoids_obj(str(tmp_path / "t.obj"), ts, **kw)
        m_j = jmesh.export_ellipsoids_obj(str(tmp_path / "j.obj"), js, **kw)
        assert m_t == m_j
        t_lines = (tmp_path / "t.obj").read_text().splitlines()[1:]
        j_lines = (tmp_path / "j.obj").read_text().splitlines()[1:]
        assert len(t_lines) == len(j_lines) == m_j * 14
        for a, b in zip(t_lines, j_lines):
            assert a[:2] == b[:2]
            if a.startswith("f "):
                assert a == b
            else:
                np.testing.assert_allclose(_numbers(a), _numbers(b),
                                           rtol=0, atol=1e-5)
    text = (tmp_path / "t.obj").read_text()
    assert text.count("\nv ") == 20 * 6 and text.count("\nf ") == 20 * 8


def test_export_names_match_goi_tpu():
    import goi_tpu.export as jexp
    import goi_tpu_torch.export as texp
    assert texp.__all__ == jexp.__all__
    assert all(callable(getattr(texp, k)) for k in texp.__all__)
    assert os.path.basename(texp.mesh.__file__) == "mesh.py"


def test_export_scene_density_along_radii():
    """chip_smoke.py's [export] scene (1M Gaussians on the unit sphere,
    scales 0.012-0.018, opacity 0.95), reckoned on the CPU along three
    radii by the plain version: a shell whose density-1 surfaces lie
    just inside r = 0.95 and r = 1.05, inside the check's radius band."""
    import chip_smoke
    scene = chip_smoke.export_scene(chip_smoke.N_GAUSS, 0, "cpu")
    packed = tmesh.pack_gaussians(scene)
    radii = np.array([0.9, 0.93, 0.95, 1.0, 1.05, 1.07, 1.1])
    for d in ([1, 0, 0], [0, 1, 0], [0.577, 0.577, -0.577]):
        d = np.asarray(d) / np.linalg.norm(d)
        pts = torch.as_tensor((radii[:, None] * d).astype(np.float32))
        dens = tmesh.mixture_at(packed, pts).numpy()
        assert dens[0] < 1e-3 and dens[-1] < 1e-3
        assert dens[1] < 0.05 and dens[5] < 0.05
        assert 0.5 < dens[2] < 1.5 and 0.5 < dens[4] < 1.5
        assert 80 < dens[3] < 140
    lo, hi = tmesh.grid_bounds(scene, None)
    assert -1.1 < lo < -1.07 and 1.07 < hi < 1.1
    band = chip_smoke.EXPORT_BAND
    assert band[0] < 0.93 and band[1] > 1.07
