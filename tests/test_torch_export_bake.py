"""goi_tpu_torch.export.texture against goi_tpu.export.texture on the
CPU: the chart layout, the bake fed goi_tpu's own render outputs (so
only the bake differs), and the one-call textured export end to end.

Tolerances: of the texels both packages bake directly, at least 99.9%
carry equal colours (the texels are projected in float32 by two matrix
products that may round differently, so a rare `round()` flips to the
next screen pixel); the sets of directly baked texels agree to the same
share. An inpainted texel carries the colour of *a* baked texel at the
least distance: on the integer atlas grid equidistant texels are
common, and goi_tpu's sklearn breaks the tie by its tree's order."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from goi_tpu.core.scene import GaussianScene
from goi_tpu.export import marching as jmarch
from goi_tpu.export import texture as jtex
from goi_tpu.raster.render import RasterConfig as JConfig
from goi_tpu.raster.render import render as jrender
from goi_tpu_torch.export import texture as ttex
from goi_tpu_torch.raster.render import RasterConfig
from tests.test_mesh_export import _ball_scene
from tests.test_torch_core import to_torch_scene

torch.set_num_threads(1)

AGREE = 0.999


@pytest.mark.parametrize("faces,size", [(1, 64), (37, 128), (900, 256),
                                        (5000, 128)])
def test_chart_layout_matches_goi_tpu(faces, size):
    for a, b in zip(ttex._chart_layout(faces, size),
                    jtex._chart_layout(faces, size)):
        np.testing.assert_array_equal(a, b)


class _Recorder:
    """Stands in for sklearn's NearestNeighbors inside goi_tpu's bake and
    keeps the baked texels it is fitted to and the holes it is asked
    about."""

    seen: dict = {}
    real = None   # sklearn's class, set before the patch

    def __init__(self, n_neighbors=1):
        self.nn = _Recorder.real(n_neighbors=n_neighbors)

    def fit(self, src):
        _Recorder.seen["src"] = src
        self.nn.fit(src)
        return self

    def kneighbors(self, dst):
        _Recorder.seen["dst"] = dst
        return self.nn.kneighbors(dst)


def _texel_set(points):
    return {tuple(p) for p in np.asarray(points).tolist()}


def _shell_scene(n=2000, seed=0, scale=0.06):
    """Gaussians on the unit sphere, red above y = 0 and blue below: a
    density shell whose inner surface no orbit view sees, so the bake
    leaves holes to inpaint."""
    rng = np.random.default_rng(seed)
    p = rng.normal(0, 1, (n, 3))
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    col = np.where(p[:, 1:2] > 0, [[0.9, 0.1, 0.1]], [[0.1, 0.1, 0.9]])
    s = GaussianScene.create(p.astype(np.float32), col.astype(np.float32),
                             sh_degree=0, sem_dim=4,
                             scales=np.full(n, scale, np.float32))
    return s.replace(opacity=jnp.full_like(s.opacity, 3.0))


def test_bake_matches_goi_tpu_on_its_renders(monkeypatch):
    import sklearn.neighbors
    js = _shell_scene()
    mesh_j = jmarch.extract_mesh(js, density_thresh=1.0, resolution=24)
    cfg = JConfig(max_instances=1 << 16, tile_cap=256, chunk=32)
    outs = []

    def jfn(cam):
        out = jrender(js, cam, jnp.zeros(3), cfg)
        outs.append({k: np.array(out[k]) for k in ("render", "alpha")})
        return out

    monkeypatch.setattr(_Recorder, "real", sklearn.neighbors.NearestNeighbors)
    monkeypatch.setattr(_Recorder, "seen", {})
    monkeypatch.setattr(sklearn.neighbors, "NearestNeighbors", _Recorder)
    want = jtex.bake_texture(jfn, jmarch.Mesh(mesh_j.vertices,
                                              mesh_j.faces),
                             texture_size=256, render_resolution=64)
    assert len(outs) == 26
    replay = iter(outs)
    seen = {}

    def tfn(cam):
        assert cam.width == cam.height == 64
        return {k: torch.as_tensor(v) for k, v in next(replay).items()}

    real_inpaint = ttex._inpaint

    def inpaint(albedo, baked, wanted):
        seen.update(albedo=albedo.copy(), baked=baked.copy(),
                    hole=wanted & ~baked)
        real_inpaint(albedo, baked, wanted)

    monkeypatch.setattr(ttex, "_inpaint", inpaint)
    got = ttex.bake_texture(tfn, ttex.Mesh(mesh_j.vertices, mesh_j.faces),
                            texture_size=256, render_resolution=64,
                            device="cpu")
    np.testing.assert_array_equal(got.uvs, want.uvs)
    assert got.albedo.shape == want.albedo.shape == (256, 256, 3)
    assert got.albedo.dtype == np.float32

    # the directly baked texels: the same set and colours, but for rare
    # round() flips
    jbaked = _texel_set(_Recorder.seen["src"])
    tbaked = _texel_set(np.stack(np.nonzero(seen["baked"]), -1))
    both = sorted(jbaked & tbaked)
    assert len(both) >= AGREE * max(len(jbaked), len(tbaked))
    assert len(both) > 1000
    rows = tuple(np.asarray(both).T)
    same = (got.albedo[rows] == want.albedo[rows]).all(1)
    assert same.mean() >= AGREE
    assert _texel_set(_Recorder.seen["dst"]) | jbaked == \
        _texel_set(np.stack(np.nonzero(seen["hole"]), -1)) | tbaked

    # each inpainted texel: the colour of a baked texel at least distance
    src = np.stack(np.nonzero(seen["baked"]), -1)
    holes = np.stack(np.nonzero(seen["hole"]), -1)
    assert len(holes) > 0
    dist, _ = cKDTree(src).query(holes, k=1)
    tree = cKDTree(src)
    for h, d in zip(holes, dist):
        near = src[tree.query_ball_point(h, d + 1e-9)]
        colours = seen["albedo"][tuple(near.T)]
        assert (colours == got.albedo[tuple(h)]).all(1).any()
    # texels outside every chart stay black
    outside = ~(seen["baked"] | seen["hole"])
    assert not got.albedo[outside].any()


def test_extract_textured_mesh_end_to_end(tmp_path):
    """tests/test_mesh_export.py's end-to-end check, on the port."""
    scene = to_torch_scene(_ball_scene())
    cfg = RasterConfig(max_instances=1 << 14)
    mesh = ttex.extract_textured_mesh(
        scene, torch.zeros(3), cfg, density_thresh=0.5, resolution=32,
        texture_size=128, render_resolution=64)
    assert len(mesh.faces) > 50
    assert mesh.uvs.shape == (len(mesh.faces) * 3, 2)
    assert mesh.albedo.shape == (128, 128, 3)
    # chart texels must be baked and carry the gaussian's red color
    baked = mesh.albedo.reshape(-1, 3)
    lit = baked[baked.sum(1) > 0.05]
    assert len(lit) > 100
    assert lit[:, 0].mean() > 2.0 * lit[:, 2].mean()

    obj = os.path.join(tmp_path, "ball.obj")
    mesh.write_obj(obj)
    assert os.path.exists(os.path.join(tmp_path, "ball.png"))
    assert os.path.exists(os.path.join(tmp_path, "ball.mtl"))
    txt = open(obj).read()
    assert "vt " in txt and "mtllib" in txt
    assert txt.count("\nf ") == len(mesh.faces)


def test_orbit_cameras_match_goi_tpu():
    """The bake's 26 views: the JAX package's look_at cameras."""
    from goi_tpu.core.camera import Camera as JCam
    center = np.array([0.1, -0.2, 0.05], np.float32)
    cams = ttex.orbit_cameras(center, 1.7, render_resolution=48, fov=0.8,
                              device="cpu")
    assert len(cams) == 26
    for (eye, cam), ver, hor in zip(cams, jtex._VERS, jtex._HORS):
        jc = JCam.look_at(eye, center, [0, 1, 0], fovx=0.8, fovy=0.8,
                          width=48, height=48)
        np.testing.assert_array_equal(cam.full_proj.numpy(),
                                      np.asarray(jc.full_proj))
        np.testing.assert_array_equal(cam.world_view.numpy(),
                                      np.asarray(jc.world_view))
        assert cam.width == cam.height == 48
