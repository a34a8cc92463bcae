"""goi_tpu_torch's SDS edit session (app/edit.py) and the query app's edit
operations against goi_tpu's: `precompute` gives the same relative
cameras, the same dilated and undilated masks (torch.equal) and the same
frozen-Gaussian mask; `train` for 2 epochs with the analytic backend and
goi_tpu's draws ends within tolerance of goi_tpu's parameters, and only
Gaussians inside grad_mask change; the web flow of
tests/test_query_web_app.py::test_query_web_app_edit_flow on both apps;
`edit=None` still refuses the edit ops; the query session's motion
survives the edit. Tolerance of the trained parameters: rtol 2e-3, atol
2e-4 of each attribute's largest change (tests/test_torch_train.py's
GRAD_TOL, taken relative to the change: both Adams see gradients within
GRAD_TOL of each other, and an update is a learning rate times the sign
of m / sqrt(v) at the first step)."""

import json
import urllib.error

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goi_tpu.app.edit import EditSession as JEdit
from goi_tpu.guidance.sds import InpaintSDS as JSDS
from goi_tpu.viewer import app as japp
from goi_tpu_torch import interop
from goi_tpu_torch.app.edit import EditSession
from goi_tpu_torch.app.session import QuerySession
from goi_tpu_torch.guidance import InpaintSDS, samplers
from goi_tpu_torch.raster.render import RasterConfig
from goi_tpu_torch.viewer import app as tapp
from tests.conftest import make_test_camera
from tests.test_app_edit import CFG as JCFG
from tests.test_app_edit import _make_session, _ToyBackend as JToy
from tests.test_torch_core import to_torch_camera, to_torch_scene
from tests.test_torch_sds import ToyBackend
from goi_tpu_torch.viewer.web import orbit_view_camera
from tests.test_torch_viewer import _apps, _decode, _get, _post

torch.set_num_threads(1)

TCFG = RasterConfig(max_instances=JCFG.max_instances)
TRAIN_TOL = (2e-3, 2e-4)
ANGLES = (0.0, 0.4, -0.4, 0.8)


def _sessions(anisotropic=False):
    """tests/test_app_edit.py's session (200 Gaussians, the first 100 of
    code 0 selected by the text) on both packages; `anisotropic` gives
    each Gaussian seeded per-axis scales, so that the rotation has a
    gradient (an isotropic Gaussian's is rounding noise, which Adam's
    first steps turn into +-lr in either package)."""
    js = _make_session()
    if anisotropic:
        rng = np.random.default_rng(12)
        js.scene = js.scene.replace(scaling=jnp.asarray(np.log(rng.uniform(
            0.02, 0.12, js.scene.scaling.shape)).astype(np.float32)))
    ts = QuerySession(
        to_torch_scene(js.scene),
        interop.decoder_from_numpy([np.asarray(js.decoder.weights[0])],
                                   [np.asarray(js.decoder.biases[0])],
                                   device="cpu"),
        interop.lut_from_numpy(np.asarray(js.lut), device="cpu"), TCFG,
        sim_thresh=js.sim_thresh, device="cpu")
    ts.set_text(np.array(js.text_tokens))
    return js, ts


def _edits(js, ts, batch_size):
    je = JEdit(js.scene, JSDS(JToy(0.9), jnp.zeros((1, 8)),
                              jnp.zeros((1, 8))), JCFG,
               batch_size=batch_size, guidance_scale=1.0, lambda_sd=1.0)
    te = EditSession(ts.scene, InpaintSDS(ToyBackend(0.9), torch.zeros(1, 8),
                                          torch.zeros(1, 8)), TCFG,
                     batch_size=batch_size, guidance_scale=1.0,
                     lambda_sd=1.0)
    return je, te


def _edit_draws(key, steps, shape):
    """goi_tpu's EditSession.train: `key, sub = split(key)` a step, then
    InpaintSDS's `_, kt, kn = split(sub, 3)` and normal(kn)."""
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        _, _, kn = jax.random.split(sub, 3)
        out.append(np.asarray(jax.random.normal(kn, shape, jnp.float32)))
    return out


def _inject_noise(monkeypatch, draws):
    queue = list(draws)

    def noise_fn(gen, shape, device):
        v = queue.pop(0)
        assert tuple(v.shape) == tuple(shape)
        return torch.as_tensor(v).to(device)

    monkeypatch.setattr(samplers, "_draw_noise", noise_fn)
    return queue


def test_precompute_matches_goi_tpu():
    js, ts = _sessions()
    je, te = _edits(js, ts, 1)
    jcams = [make_test_camera(width=40, height=32, angle=a) for a in ANGLES]
    # a view that sees little of the target, to be dropped at ratio 0.5
    jcams.append(make_test_camera(width=40, height=32, dist=9.0,
                                  angle=2.6))
    for ratio in (0.1, 0.5):
        n = je.precompute(jcams, js.compute_similarity,
                          min_relative_ratio=ratio)
        assert te.precompute([to_torch_camera(c) for c in jcams],
                             ts.compute_similarity,
                             min_relative_ratio=ratio) == n
        assert n >= 1
        np.testing.assert_array_equal(te.grad_mask.numpy(),
                                      np.asarray(je.grad_mask))
        for a, b in zip(te.relative_cameras, je.relative_cameras):
            assert torch.equal(a.camera.world_view,
                               torch.as_tensor(np.asarray(b.camera
                                                          .world_view)))
            assert a.mask.dtype == torch.bool
            assert torch.equal(a.mask, torch.as_tensor(b.mask))
            assert torch.equal(a.mask_nodilated,
                               torch.as_tensor(b.mask_nodilated))
            assert int(a.mask.sum()) > int(a.mask_nodilated.sum())
    assert 100 >= int(te.grad_mask.sum()) > 90


def test_train_matches_goi_tpu(monkeypatch):
    """2 epochs of 4 relative cameras in batches of 2 (4 steps, annealed
    t), from the same scene and the same noise."""
    js, ts = _sessions(anisotropic=True)
    je, te = _edits(js, ts, 2)
    jcams = [make_test_camera(width=32, height=32, angle=a) for a in ANGLES]
    assert je.precompute(jcams, js.compute_similarity) == 4
    assert te.precompute([to_torch_camera(c) for c in jcams],
                         ts.compute_similarity) == 4
    left = _inject_noise(monkeypatch, _edit_draws(
        jax.random.PRNGKey(0), 4, (2, 4, 64, 64)))
    before = {k: v.clone() for k, v in te.scene.params().items()}
    je.train(epochs=2, log_every=100)
    te.train(epochs=2, log_every=100)
    assert not left and te.steps == 4
    gm = te.grad_mask.numpy() > 0
    moved = np.zeros(len(gm), bool)
    for k, v in te.scene.params().items():
        got, want = v.numpy(), np.asarray(getattr(je.scene, k))
        change = np.abs(want - before[k].numpy())
        changed = (got != before[k].numpy()).reshape(len(gm), -1).any(1)
        assert not changed[~gm].any(), k
        moved |= changed
        if change.max() > 0:
            np.testing.assert_allclose(
                got, want, rtol=TRAIN_TOL[0],
                atol=TRAIN_TOL[1] * change.max(), err_msg=k)
    assert moved[gm].sum() > 10
    assert not te.scene.xyz.requires_grad
    for p in te.opt.param_groups:
        assert float(te.opt.state[p["params"][0]]["step"]) == 4


def test_train_keeps_adam_state_across_calls(monkeypatch):
    """The session's Adam state carries over a second train call and a
    scene handed in between (the app's edit_precompute adopts the query
    scene), as goi_tpu's opt_state does."""
    js, ts = _sessions()
    _, te = _edits(js, ts, 1)
    cams = [to_torch_camera(make_test_camera(width=32, height=32, angle=a))
            for a in ANGLES[:2]]
    te.precompute(cams, ts.compute_similarity)
    n = len(te.relative_cameras)
    te.train(torch.Generator().manual_seed(1), epochs=1, log_every=100)
    te.scene = te.scene.replace(valid=te.scene.valid.clone())
    te.precompute(cams, ts.compute_similarity)
    te.train(torch.Generator().manual_seed(2), epochs=1, log_every=100)
    assert te.steps == 2 * n
    for group in te.opt.param_groups:
        (p,) = group["params"]
        assert torch.equal(p.detach(), te.scene.params()[group["name"]])
        assert float(te.opt.state[p]["step"]) == 2 * n
    with pytest.raises(ValueError, match="precompute"):
        _edits(js, ts, 1)[1].train()


def test_query_web_app_edit_flow_matches_goi_tpu(tmp_path):
    """tests/test_query_web_app.py::test_query_web_app_edit_flow on both
    apps: the same relative-camera count, /state's edit entry, and after
    edit_train only target Gaussians changed and the app renders the
    edited scene."""
    jsess, tsess, text = _apps()
    jedit = JEdit(jsess.scene, JSDS(JToy(0.9), jnp.zeros((1, 8)),
                                    jnp.zeros((1, 8))),
                  jsess.raster_cfg, batch_size=1, guidance_scale=1.0,
                  lambda_sd=1.0)
    tedit = EditSession(tsess.scene, InpaintSDS(
        ToyBackend(0.9), torch.zeros(1, 8), torch.zeros(1, 8)),
        tsess.raster_cfg, batch_size=1, guidance_scale=1.0, lambda_sd=1.0)
    jcams = [make_test_camera(width=32, height=32, angle=a)
             for a in (0.0, 0.4)]
    ja = japp.QueryWebApp(jsess, text_fn=lambda p: text[p], edit=jedit,
                          edit_cameras=jcams, host="127.0.0.1", port=0)
    ta = tapp.QueryWebApp(tsess, text_fn=lambda p: torch.as_tensor(text[p]),
                          edit=tedit,
                          edit_cameras=[to_torch_camera(c) for c in jcams],
                          host="127.0.0.1", port=0)
    ja.start()
    ta.start()
    jb, tb = f"http://127.0.0.1:{ja.port}", f"http://127.0.0.1:{ta.port}"
    view = "/frame?elev=10&azim=-20&radius=3.5&w=64&h=48"
    try:
        for base in (jb, tb):
            _post(base, {"op": "set_text", "prompt": "left thing"})
        got = _post(tb, {"op": "edit_precompute"})
        assert got == _post(jb, {"op": "edit_precompute"})
        assert got["ok"] and got["relative_cameras"] >= 1
        st = json.loads(_get(tb, "/state").read())
        assert st["edit"] == {"relative_cameras": got["relative_cameras"]}
        assert st == json.loads(_get(jb, "/state").read())

        before = tsess.scene.features_dc.clone()
        frame_before = _get(tb, view).read()
        got = _post(tb, {"op": "edit_train", "epochs": 2, "log_every": 100})
        assert got == _post(jb, {"op": "edit_train", "epochs": 2,
                                 "log_every": 100})
        assert got["ok"] and got["num_valid"] == 300
        assert torch.equal(tsess.scene.features_dc, tedit.scene.features_dc)
        changed = (tsess.scene.features_dc != before).reshape(300, -1).any(1)
        gm = tedit.grad_mask > 0
        assert changed[gm].any() and not changed[~gm].any()
        jchanged = np.abs(np.asarray(jsess.scene.features_dc)
                          - before.numpy()).sum(axis=(1, 2)) > 1e-7
        assert np.array_equal(changed.numpy(), jchanged)
        frame_after = _get(tb, view).read()
        assert frame_after != frame_before
        want = tsess.render_view(orbit_view_camera(
            {"elev": 10, "azim": -20, "radius": 3.5, "w": 64, "h": 48}, 50.0,
            "cpu"), as_u8=True)
        np.testing.assert_array_equal(_decode(frame_after), want)
    finally:
        ja.stop()
        ta.stop()


def test_edit_ops_without_an_edit_session_raise():
    _, tsess, text = _apps()
    ta = tapp.QueryWebApp(tsess, text_fn=lambda p: torch.as_tensor(text[p]),
                          host="127.0.0.1", port=0)
    ta.start()
    base = f"http://127.0.0.1:{ta.port}"
    try:
        assert json.loads(_get(base, "/state").read())["edit"] is None
        for op in ("edit_precompute", "edit_train"):
            with pytest.raises(urllib.error.HTTPError) as exc:
                _post(base, {"op": op})
            assert exc.value.code == 500
            assert "no edit session configured" in json.loads(
                exc.value.read())["error"]
    finally:
        ta.stop()


def test_motion_survives_the_edit():
    """A move before edit_train stays undoable after it: reset subtracts
    the motion from the edited positions (goi_tpu's reset_motion), and
    no Gaussian outside the move is touched."""
    _, ts = _sessions()
    ts.retrieve()
    rest = ts.scene.xyz.clone()
    ts.move([0.25, 0.0, -0.5])
    edited = ts.scene.replace(xyz=ts.scene.xyz + 0.01)
    ts.adopt_scene(edited)
    assert torch.equal(ts.scene.xyz, edited.xyz)
    ts.reset_motion()
    want = edited.xyz - torch.as_tensor(ts.rel_gs_index[:, None]
                                        * np.float32([0.25, 0.0, -0.5]))
    assert torch.equal(ts.scene.xyz, want)
    np.testing.assert_allclose(ts.scene.xyz.numpy(), rest.numpy() + 0.01,
                               atol=1e-6)
