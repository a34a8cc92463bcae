"""goi_tpu_torch's pose interpolation and orbit cameras against goi_tpu:
slerp and interpolate_poses, the quaternion OrbitCamera and the NGP
camera over the same op sequences (tests/test_orbit_ngp.py and
tests/test_app_edit.py::test_orbit_camera mirrored), and the renderer
cameras they build."""

import numpy as np
import pytest
import torch

from goi_tpu.app import orbit as jorbit
from goi_tpu.app import orbit_ngp as jngp
from goi_tpu.utils import pose as jpose
from goi_tpu_torch.app import orbit as torbit
from goi_tpu_torch.app import orbit_ngp as tngp
from goi_tpu_torch.core.camera import Camera, ndc2pix, project_points
from goi_tpu_torch.raster.render import RasterConfig, render
from goi_tpu_torch.utils import pose as tpose
from tests.conftest import make_random_scene
from tests.test_torch_core import to_torch_scene

torch.set_num_threads(1)


def _rot(axis, th):
    c, s = np.cos(th), np.sin(th)
    m = np.eye(4)
    i, j = [k for k in range(3) if k != axis]
    m[i, i], m[i, j], m[j, i], m[j, j] = c, -s, s, c
    return m


def _same_camera(tc, jc):
    assert (tc.width, tc.height) == (jc.width, jc.height)
    for k in ("world_view", "full_proj", "camera_center", "tan_fovx",
              "tan_fovy"):
        np.testing.assert_array_equal(getattr(tc, k).numpy(),
                                      np.asarray(getattr(jc, k)))


def test_slerp_and_interpolate_poses_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(6):
        q0, q1 = rng.normal(0, 1, (2, 4))
        for t in (0.0, 0.25, 0.5, 0.9):
            np.testing.assert_array_equal(tpose.slerp(q0, q1, t),
                                          jpose.slerp(q0, q1, t))
    # nearly equal quaternions take the normalized-lerp branch
    q = np.array([1.0, 1e-4, 0, 0])
    np.testing.assert_array_equal(tpose.slerp(q, q + 1e-5, 0.3),
                                  jpose.slerp(q, q + 1e-5, 0.3))
    a = np.eye(4)
    b = _rot(2, np.pi / 2)
    b[:3, 3] = [1.0, 0, 0]
    c = _rot(0, 0.7) @ b
    c[:3, 3] = [0.5, -1.0, 2.0]
    tp = tpose.interpolate_poses([a, b, c], steps_per_segment=7)
    jp = jpose.interpolate_poses([a, b, c], steps_per_segment=7)
    assert len(tp) == len(jp) == 15
    for x, y in zip(tp, jp):
        np.testing.assert_array_equal(x, y)
    # tests/test_data_io.py::test_pose_interpolation's midpoint
    mid = tpose.interpolate_poses([a, b], steps_per_segment=10)[5]
    np.testing.assert_allclose(mid[:3, 3], [0.5, 0, 0], atol=1e-6)
    assert abs(np.linalg.det(mid[:3, :3]) - 1) < 1e-6


def test_orbit_camera_ops_match_jax():
    tc = torbit.OrbitCamera(64, 48, r=3.0, fovy=50)
    jc = jorbit.OrbitCamera(64, 48, r=3.0, fovy=50)
    pose0 = tc.pose.copy()
    for op, args in (("orbit", (30, 10)), ("scale", (1.0,)),
                     ("pan", (10, 5)), ("orbit", (-12, 4, 3)),
                     ("scale", (-2.5,))):
        getattr(tc, op)(*args)
        getattr(jc, op)(*args)
        np.testing.assert_array_equal(tc.pose, jc.pose)
    assert not np.allclose(tc.pose, pose0) and tc.radius != 3.0
    np.testing.assert_array_equal(tc.view, jc.view)
    np.testing.assert_array_equal(tc.campos, jc.campos)
    _same_camera(tc.to_camera(device="cpu"), jc.to_camera())
    c2w = jorbit.OrbitCamera(64, 48, r=2.0).pose
    c2w[:3, :3] = _rot(1, 0.4)[:3, :3] @ c2w[:3, :3]
    tc.import_pose(c2w)
    jc.import_pose(c2w)
    assert tc.radius == jc.radius == 0.0
    tc.scale(1.0)
    jc.scale(1.0)
    np.testing.assert_array_equal(tc.pose, jc.pose)
    # renderable (tests/test_app_edit.py::test_orbit_camera)
    scene = to_torch_scene(make_random_scene(n=50, seed=2))
    out = render(scene, tc.to_camera(device="cpu"), torch.zeros(3),
                 RasterConfig(max_instances=1 << 13))
    assert torch.isfinite(out["render"]).all()


def test_ngp_helpers_match_jax():
    for el, az, r in ((0, 0, 2.0), (0, 90, 2.0), (90, 0, 2.0),
                      (20.0, 35.0, 3.0), (-15.0, 120.0, 2.5)):
        np.testing.assert_array_equal(tngp.orbit_pose(el, az, r),
                                      jngp.orbit_pose(el, az, r))
    np.testing.assert_array_equal(
        tngp.orbit_pose(0.3, 1.0, 1.5, is_degree=False, target=[1, 2, 3],
                        opengl=False),
        jngp.orbit_pose(0.3, 1.0, 1.5, is_degree=False, target=[1, 2, 3],
                        opengl=False))
    # tests/test_orbit_ngp.py's conventions
    np.testing.assert_allclose(tngp.orbit_pose(0, 90, 2.0)[:3, 3], [2, 0, 0],
                               atol=1e-6)
    np.testing.assert_allclose(
        tngp.look_at_rotation([0, 0, 3], [0, 0, 0], opengl=False)[:, 2],
        [0, 0, -1], atol=1e-6)
    assert tngp.intrinsic_to_fov(400.0, 300.0, 640, 480) == \
        jngp.intrinsic_to_fov(400.0, 300.0, 640, 480)


def test_ngp_camera_matches_jax_and_look_at():
    tc = tngp.NGPOrbitCamera(64, 48, r=3.0, fovy=50.0)
    jc = jngp.NGPOrbitCamera(64, 48, r=3.0, fovy=50.0)
    for cam in (tc, jc):
        cam.orbit_to(20.0, 35.0)
    for k in ("pose", "campos", "view", "perspective", "intrinsics", "mvp"):
        np.testing.assert_array_equal(getattr(tc, k), getattr(jc, k))
    c = tc.to_camera(device="cpu")
    _same_camera(c, jc.to_camera())
    # the NGP camera projects like the renderer's look_at camera from the
    # same spot (tests/test_orbit_ngp.py::test_to_camera_matches_look_at)
    ref = Camera.look_at(tc.campos, [0, 0, 0], [0, 1, 0], fovx=tc.fovx,
                         fovy=tc.fovy, width=64, height=48, device="cpu")
    pts = torch.as_tensor(np.random.default_rng(0).normal(
        0, 0.4, (20, 3)).astype(np.float32))
    pa, va = project_points(pts, c)
    pb, vb = project_points(pts, ref)
    np.testing.assert_allclose(va.numpy(), vb.numpy(), atol=1e-4)
    for k, size in ((0, 64), (1, 48)):
        np.testing.assert_allclose(ndc2pix(pa[:, k], size).numpy(),
                                   ndc2pix(pb[:, k], size).numpy(), atol=1e-3)
    tc.set_pose(jc.pose)
    np.testing.assert_array_equal(tc.pose, jc.pose)
    h = tc.mvp @ np.array([0, 0, 0, 1.0])
    np.testing.assert_allclose(h[:2] / h[3], 0.0, atol=1e-5)


@pytest.mark.parametrize("cls", [torbit.OrbitCamera, tngp.NGPOrbitCamera])
def test_cameras_default_to_the_card(cls, monkeypatch):
    """to_camera() builds on the card unless asked for another device."""
    seen = []
    real = Camera.from_Rt

    def spy(*a, **kw):
        seen.append(kw.get("device"))
        return real(*a, **{**kw, "device": "cpu"})

    monkeypatch.setattr(Camera, "from_Rt", staticmethod(spy))
    cls(32, 24).to_camera()
    cls(32, 24).to_camera(device="cpu")
    assert seen == ["cuda", "cpu"]
