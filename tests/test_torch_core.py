"""goi_tpu_torch core modules against goi_tpu: scene activations and
covariance, SH, camera matrices, and the PLY codec across packages.

Also holds the numpy bridges the other test_torch_* files use."""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goi_tpu.core import camera as jcam
from goi_tpu.core import ply as jply
from goi_tpu.core import scene as jscene
from goi_tpu.core import sh as jsh
from goi_tpu_torch import interop
from goi_tpu_torch.core import camera as tcam
from goi_tpu_torch.core import ply as tply
from goi_tpu_torch.core import scene as tscene
from goi_tpu_torch.core import sh as tsh
from tests.conftest import make_random_scene, make_test_camera

torch.set_num_threads(1)

RTOL = 1e-6


def to_torch_scene(s, device="cpu"):
    fields = {k: np.asarray(getattr(s, k))
              for k in s.PARAM_FIELDS + ("valid",)}
    return interop.scene_from_numpy(
        fields, active_sh_degree=s.active_sh_degree,
        max_sh_degree=s.max_sh_degree, device=device)


def to_torch_camera(c, device="cpu"):
    return interop.camera_from_numpy(
        np.asarray(c.world_view), np.asarray(c.full_proj),
        np.asarray(c.camera_center), np.asarray(c.tan_fovx),
        np.asarray(c.tan_fovy), c.width, c.height, device=device)


def close(a, b, rtol=RTOL, atol=1e-7):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def test_scene_activations_and_covariance():
    js = make_random_scene(n=200, seed=1, capacity=256, anisotropic=True)
    ts = to_torch_scene(js)
    assert ts.capacity == js.capacity == 256
    assert ts.sem_dim == js.sem_dim
    assert int(ts.num_valid) == int(js.num_valid)
    close(ts.get_scaling(), js.get_scaling())
    close(ts.get_opacity(), js.get_opacity())
    close(ts.get_rotation(), js.get_rotation())
    close(ts.get_features(), js.get_features())
    close(ts.get_covariance(1.3), js.get_covariance(1.3))
    q = np.array(js.get_rotation())
    close(tscene.build_rotation_matrix(torch.as_tensor(q)),
          jscene.build_rotation_matrix(jnp.asarray(q)))
    mask = np.random.default_rng(0).uniform(0, 1, 256).astype(np.float32)
    close(ts.get_semantics(torch.as_tensor(mask)),
          js.get_semantics(jnp.asarray(mask)))


def test_rotation_norm_clamp_keeps_tiny_quaternions_finite():
    js = make_random_scene(n=8, seed=2)
    rot = np.asarray(js.rotation).copy()
    rot[:3] = 1e-30
    js = js.replace(rotation=jnp.asarray(rot))
    ts = to_torch_scene(js)
    assert torch.isfinite(ts.get_rotation()).all()
    close(ts.get_rotation(), js.get_rotation())


def test_scene_create_params_and_sh_degree():
    rng = np.random.default_rng(3)
    xyz = rng.normal(0, 1, (50, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (50, 3)).astype(np.float32)
    scales = rng.uniform(0.01, 0.1, 50).astype(np.float32)
    js = jscene.GaussianScene.create(xyz, cols, sh_degree=2, sem_dim=4,
                                     scales=scales, capacity=64)
    ts = tscene.GaussianScene.create(xyz, cols, sh_degree=2, sem_dim=4,
                                     scales=scales, capacity=64,
                                     device="cpu")
    for f in js.PARAM_FIELDS + ("valid",):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), f)
    assert list(ts.params()) == list(js.params())
    p = {k: v * 2 for k, v in ts.params().items()}
    ts2 = ts.with_params(p)
    assert torch.equal(ts2.xyz, ts.xyz * 2) and ts2.valid is ts.valid
    up = ts.one_up_sh_degree().one_up_sh_degree().one_up_sh_degree()
    assert up.active_sh_degree == 2 == js.max_sh_degree
    with pytest.raises(ValueError):
        tscene.GaussianScene.create(xyz, capacity=10, device="cpu")


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_eval_sh_and_color(deg):
    rng = np.random.default_rng(deg)
    sh = rng.normal(0, 1, (40, 16, 3)).astype(np.float32)
    dirs = rng.normal(0, 1, (40, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    close(tsh.eval_sh(deg, torch.as_tensor(sh), torch.as_tensor(dirs)),
          jsh.eval_sh(deg, jnp.asarray(sh), jnp.asarray(dirs)),
          atol=1e-6)
    xyz = rng.normal(0, 1, (40, 3)).astype(np.float32)
    cc = np.array([0.3, -1.0, 4.0], np.float32)
    close(tsh.sh_to_color(deg, torch.as_tensor(sh), torch.as_tensor(xyz),
                          torch.as_tensor(cc)),
          jsh.sh_to_color(deg, jnp.asarray(sh), jnp.asarray(xyz),
                          jnp.asarray(cc)), atol=1e-6)
    rgb = rng.uniform(0, 1, (5, 3)).astype(np.float32)
    close(tsh.rgb_to_sh(rgb), jsh.rgb_to_sh(rgb))
    close(tsh.sh_to_rgb(torch.as_tensor(rgb)), jsh.sh_to_rgb(jnp.asarray(rgb)))


def test_camera_matrices_and_projection():
    jc = make_test_camera(width=64, height=48, angle=0.7)
    eye = np.array([4.0 * np.sin(0.7), 0.4, -4.0 * np.cos(0.7)])
    tc = tcam.Camera.look_at(eye, [0, 0, 0], [0, 1, 0], fovx=0.9, fovy=0.7,
                             width=64, height=48, device="cpu")
    for f in ("world_view", "full_proj", "camera_center", "tan_fovx",
              "tan_fovy"):
        close(getattr(tc, f), getattr(jc, f))
    assert (tc.width, tc.height) == (jc.width, jc.height)
    close(tc.focal_x, jc.focal_x)
    close(tc.focal_y, jc.focal_y)
    rng = np.random.default_rng(5)
    R = np.linalg.qr(rng.normal(0, 1, (3, 3)))[0]
    t = rng.normal(0, 1, 3)
    np.testing.assert_array_equal(
        tcam.get_world2view(R, t, np.array([0.1, 0.2, 0.3]), 1.5),
        jcam.get_world2view(R, t, np.array([0.1, 0.2, 0.3]), 1.5))
    np.testing.assert_array_equal(tcam.get_projection_matrix(0.01, 100, 0.9, 0.7),
                                  jcam.get_projection_matrix(0.01, 100, 0.9, 0.7))
    assert tcam.fov2focal(0.9, 640) == jcam.fov2focal(0.9, 640)
    assert tcam.focal2fov(700.0, 640) == jcam.focal2fov(700.0, 640)
    close(tcam.ndc2pix(torch.tensor([-1.0, 0.2, 1.0]), 64),
          jcam.ndc2pix(jnp.array([-1.0, 0.2, 1.0]), 64))
    xyz = rng.normal(0, 1, (30, 3)).astype(np.float32)
    tp = tcam.project_points(torch.as_tensor(xyz), to_torch_camera(jc))
    jp = jcam.project_points(jnp.asarray(xyz), jc)
    close(tp[0], jp[0], rtol=1e-5, atol=1e-6)
    close(tp[1], jp[1], rtol=1e-5, atol=1e-6)
    tr = tcam.Camera.from_Rt(R, t, 0.8, 0.6, 32, 24, device="cpu")
    jr = jcam.Camera.from_Rt(R, t, 0.8, 0.6, 32, 24)
    close(tr.full_proj, jr.full_proj)


def _assert_scenes_equal(ts, js):
    for f in js.PARAM_FIELDS + ("valid",):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), f)
    assert ts.active_sh_degree == js.active_sh_degree
    assert ts.max_sh_degree == js.max_sh_degree


@pytest.mark.parametrize("sh_degree", [0, 3])
def test_ply_round_trip_across_packages(tmp_path, sh_degree):
    js = make_random_scene(n=120, seed=4, sh_degree=sh_degree)
    jpath = str(tmp_path / "jax.ply")
    jply.save_gaussians_ply(jpath, js)
    ts = tply.load_gaussians_ply(jpath, device="cpu", capacity=128)
    js_back = jply.load_gaussians_ply(jpath, capacity=128)
    _assert_scenes_equal(ts, js_back)

    tpath = str(tmp_path / "torch.ply")
    tply.save_gaussians_ply(tpath, ts)
    assert open(tpath, "rb").read() == open(jpath, "rb").read()
    _assert_scenes_equal(ts, jply.load_gaussians_ply(tpath, capacity=128))
    assert dataclasses.fields(ts)  # a dataclass of tensors


def test_ply_reader_matches_on_ascii_and_faces(tmp_path):
    p = str(tmp_path / "m.ply")
    props = {"x": np.arange(4, dtype=np.float32),
             "y": np.ones(4, np.float32), "z": -np.arange(4.0, dtype=np.float32),
             "red": np.arange(4, dtype=np.uint8)}
    jply.write_ply(p, props, faces=np.array([[0, 1, 2], [1, 2, 3]]))
    tv, jv = tply.read_ply(p), jply.read_ply(p)
    assert list(tv) == list(jv)
    for k in jv:
        np.testing.assert_array_equal(tv[k], jv[k])
    a = str(tmp_path / "a.ply")
    with open(a, "w") as f:
        f.write("ply\nformat ascii 1.0\nelement vertex 2\nproperty float x\n"
                "property float y\nend_header\n1.5 2\n3 4.25\n")
    np.testing.assert_array_equal(tply.read_ply(a)["y"], jply.read_ply(a)["y"])
    assert math.isclose(float(tply.read_ply(a)["x"][0]), 1.5)
