"""goi_tpu_torch's QuerySession.group_points and render_path, the render
API's render_batch and RasterConfig.debug, against goi_tpu on the CPU:
group_points' keep mask equal to the JAX session's (sklearn's DBSCAN)
on tests/test_app_edit.py::test_group_points_dbscan's scene, path frames
and batched renders within tests/test_pallas_blend.py's 5e-5, the debug
dump on a non-finite frame and none on a clean one."""

import dataclasses
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goi_tpu.app.session import QuerySession as JSession
from goi_tpu.dist.shard import stack_cameras
from goi_tpu.raster import RasterConfig as JConfig
from goi_tpu.raster import render as jrender
from goi_tpu.raster.render import render_batch as j_render_batch
from goi_tpu.semantic.codebook import SemanticDecoder as JDecoder
from goi_tpu.utils import image as jimage
from goi_tpu_torch import interop
from goi_tpu_torch.app.session import QuerySession as TSession
from goi_tpu_torch.raster.preprocess import preprocess
from goi_tpu_torch.raster.render import (DEBUG_DUMP, RasterConfig, render,
                                         render_batch)
from goi_tpu_torch.utils import image as timage
from tests.conftest import make_random_scene, make_test_camera
from tests.test_torch_core import to_torch_camera, to_torch_scene
from tests.test_torch_query import TCFG, _sessions

torch.set_num_threads(1)

TOL = dict(rtol=5e-5, atol=5e-5)
# tests/test_app_edit.py's config (the xla backend)
JCFG_XLA = JConfig(max_instances=1 << 13, tile_cap=256, chunk=32)


def _grouping_sessions():
    """test_group_points_dbscan's setup on both packages (the first 50
    Gaussians of the retrieved half moved 5 units away), with the halves
    on codes 1 and 5 rather than 0 and 1: a pixel with no semantics
    decodes to code 0, which matches a query of code 0 (and there a
    cluster's own mask holds the whole background, which no keep mask
    survives), and code 1's query rejects codes 0 and 5."""
    js = make_random_scene(n=200, seed=0)
    sems = np.zeros((js.capacity, 10), np.float32)
    sems[:100, 1] = 3.0
    sems[100:, 5] = 3.0
    js = js.replace(semantics=jnp.asarray(sems))
    lut = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (10, 64)))
    text = lut[1] / np.linalg.norm(lut[1]) * 10.0
    jsess = JSession(js, JDecoder(weights=[jnp.eye(10) * 4.0],
                                  biases=[jnp.zeros(10)]),
                     jnp.asarray(lut), JCFG_XLA, sim_thresh=0.86)
    tsess = TSession(to_torch_scene(js), interop.decoder_from_numpy(
        [np.eye(10) * 4.0], [np.zeros(10)], device="cpu"),
        interop.lut_from_numpy(lut, device="cpu"), TCFG, sim_thresh=0.86,
        device="cpu")
    jsess.set_text(jnp.asarray(text))
    tsess.set_text(text)
    xyz = np.asarray(jsess.scene.xyz).copy()
    xyz[:50] += np.array([5.0, 0, 0], np.float32)
    jsess.scene = jsess.scene.replace(xyz=jnp.asarray(xyz))
    tsess.scene = tsess.scene.replace(xyz=torch.as_tensor(xyz))
    jsess.retrieve()
    tsess.retrieve()
    np.testing.assert_array_equal(tsess.rel_gs_index, jsess.rel_gs_index)
    return jsess, tsess


@pytest.mark.parametrize("eps,min_samples", [(1.0, 10), (0.6, 5)])
def test_group_points_keeps_the_jax_sessions_mask(eps, min_samples):
    jsess, tsess = _grouping_sessions()
    cam = make_test_camera(width=48, height=32)
    out = jrender(jsess.scene, cam, jnp.ones(3), jsess.raster_cfg)
    sim = jsess.compute_similarity(out["semantics"].reshape(10, -1).T)
    res_mask = np.asarray(sim > 0).reshape(32, 48)
    retrieved = int(jsess.rel_gs_index.sum())
    # ratio 0.4: where code-5 Gaussians cover the object, its clusters'
    # own renders still decode to code 1, so about half of their mask lies
    # outside the full render's
    jkeep = jsess.group_points(cam, res_mask, eps=eps,
                               min_samples=min_samples, ratio_thresh=0.4)
    tkeep = tsess.group_points(to_torch_camera(cam), res_mask, eps=eps,
                               min_samples=min_samples, ratio_thresh=0.4)
    assert tkeep.dtype == bool and tkeep.shape == jkeep.shape
    np.testing.assert_array_equal(tkeep, jkeep)
    np.testing.assert_array_equal(tsess.rel_gs_index, jkeep)
    # the moved cluster is off-screen and dropped; the on-screen one kept
    assert 0 < tkeep.sum() < retrieved and not tkeep[:50].any()


def test_render_path_frames_match_jax():
    jsess, tsess = _sessions()
    anchors = []
    for angle in (0.0, 0.5, 1.1):
        w2c = np.asarray(make_test_camera(angle=angle).world_view,
                         np.float64)
        anchors.append(np.linalg.inv(w2c))
    for mode in ("image", "depth"):
        jf = jsess.render_path(anchors, 40, 24, 0.9, 0.7,
                               steps_per_segment=3, mode=mode)
        tf = tsess.render_path(anchors, 40, 24, 0.9, 0.7,
                               steps_per_segment=3, mode=mode)
        assert len(tf) == len(jf) == 7
        for a, b in zip(tf, jf):
            assert a.shape == (24, 40, 3)
            np.testing.assert_allclose(a, b, **TOL)


def test_render_batch_matches_jax_and_single_renders():
    js = make_random_scene(n=60, seed=3)
    ts = to_torch_scene(js)
    jcams = [make_test_camera(width=32, height=32, angle=a)
             for a in (0.0, 0.3, 0.9)]
    jout = j_render_batch(js, stack_cameras(jcams), jnp.zeros(3), JCFG_XLA)
    tcams = [to_torch_camera(c) for c in jcams]
    cfg = RasterConfig(max_instances=1 << 12)
    tout = render_batch(ts, tcams, torch.zeros(3), cfg)
    for k in ("render", "semantics", "depth", "alpha"):
        assert tout[k].shape[0] == 3
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   **TOL)
    for i, cam in enumerate(tcams):
        single = render(ts, cam, torch.zeros(3), cfg)
        for k, v in single.items():
            assert torch.equal(tout[k][i], v), k


def test_debug_dumps_the_splats_of_a_non_finite_frame(tmp_path, monkeypatch,
                                                      capsys):
    monkeypatch.chdir(tmp_path)
    js = make_random_scene(n=200, seed=0)
    ts = to_torch_scene(js)
    jcam = make_test_camera(width=48, height=32)
    cam = to_torch_camera(jcam)
    dbg = RasterConfig(max_instances=1 << 13, debug=True)
    out = render(ts, cam, torch.zeros(3), dbg)
    assert torch.isfinite(out["render"]).all()
    assert not (tmp_path / DEBUG_DUMP).exists()
    # a NaN position is culled, as goi_tpu culls it: the frame stays
    # finite (and equal to goi_tpu's) and nothing is dumped
    for k in (5, 199):
        xyz = np.asarray(js.xyz).copy()
        xyz[k, 0] = np.nan
        tout = render(ts.replace(xyz=torch.as_tensor(xyz)), cam,
                      torch.zeros(3), dbg)
        jout = jrender(js.replace(xyz=jnp.asarray(xyz)), jcam, jnp.zeros(3),
                       JConfig(max_instances=1 << 13, backend="pallas"))
        for key in ("render", "semantics"):
            np.testing.assert_allclose(tout[key].numpy(),
                                       np.asarray(jout[key]), **TOL)
        assert not (tmp_path / DEBUG_DUMP).exists()
    # a NaN semantic channel of a visible Gaussian reaches the frame
    sp = preprocess(ts, cam)
    k = int(torch.nonzero(sp.radius > 0)[0])
    sem = ts.semantics.clone()
    sem[k, 3] = float("nan")
    bad = ts.replace(semantics=sem)
    out = render(bad, cam, torch.zeros(3), dbg)
    assert not torch.isfinite(out["semantics"]).all()
    assert "non-finite render output" in capsys.readouterr().out
    with open(tmp_path / DEBUG_DUMP, "rb") as f:
        dump = pickle.load(f)
    want = preprocess(bad, cam)
    assert set(dump) == {f.name for f in dataclasses.fields(want)}
    for name, arr in dump.items():
        assert isinstance(arr, np.ndarray)
        np.testing.assert_array_equal(arr, getattr(want, name).numpy())
    # off by default: no host test, no file
    (tmp_path / DEBUG_DUMP).unlink()
    render(bad, cam, torch.zeros(3), RasterConfig(max_instances=1 << 13))
    assert not (tmp_path / DEBUG_DUMP).exists()


def test_session_has_every_method_of_the_jax_session():
    public = {m for m in dir(JSession) if not m.startswith("_")}
    assert public <= set(dir(TSession)), public - set(dir(TSession))


def test_image_helpers_match_jax(tmp_path, monkeypatch):
    """apply_mask, calculate_iou, nyu40_colorize and write_video, the rest
    of utils/image.py (tests/test_export_misc.py::test_nyu40_colorize)."""
    rng = np.random.default_rng(4)
    a = rng.normal(0, 1, (5, 3, 2)).astype(np.float32)
    m = rng.uniform(0, 1, 5) > 0.5
    np.testing.assert_array_equal(
        timage.apply_mask(torch.as_tensor(a), torch.as_tensor(m)).numpy(),
        np.asarray(jimage.apply_mask(a, m)))
    lab, pred = rng.uniform(0, 1, (2, 16, 16)) > 0.5
    assert timage.calculate_iou(lab, pred) == jimage.calculate_iou(lab, pred)
    assert timage.calculate_iou(lab & False, pred & False) == 0.0
    labels = np.array([[0, 1], [40, 99], [-3, 7]])
    np.testing.assert_array_equal(timage.nyu40_colorize(labels),
                                  jimage.nyu40_colorize(labels))
    np.testing.assert_array_equal(timage.NYU40_COLORS, jimage.NYU40_COLORS)
    frames = [rng.uniform(0, 1, (32, 48, 3)).astype(np.float32)
              for _ in range(3)]
    out = str(tmp_path / "a.mp4")
    assert timage.write_video(frames, out) == out
    assert (tmp_path / "a.mp4").stat().st_size > 0
    # neither writer: an ImportError that names both, and no file
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "imageio", None)
    with pytest.raises(ImportError, match="cv2.*imageio"):
        timage.write_video(frames, str(tmp_path / "b.mp4"))
    assert not (tmp_path / "b.mp4").exists()
