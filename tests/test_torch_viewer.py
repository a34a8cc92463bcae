"""goi_tpu_torch's viewers against goi_tpu's over loopback: the WebViewer
page and frames (tests/test_web_viewer.py), QueryWebApp's whole
operation surface on both packages side by side
(tests/test_query_web_app.py: retrieved, kept and num_valid counts
equal, decoded frames within one 8-bit level, the edit operations
refused), both pages revoking their object URLs, the SIBR NetworkGUI
(tests/test_data_io.py::test_viewer_protocol_loopback; the camera it
rebuilds equal to goi_tpu's), and `python -m goi_tpu_torch.viewer
--device cpu` serving one frame of a model directory."""

import io
import json
import os
import re
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from goi_tpu.app.session import QuerySession as JSession
from goi_tpu.core.scene import GaussianScene as JScene
from goi_tpu.raster import RasterConfig as JConfig
from goi_tpu.raster import render as jrender
from goi_tpu.semantic.codebook import SemanticDecoder as JDecoder
from goi_tpu.viewer import app as japp
from goi_tpu.viewer import server as jserver
from goi_tpu.viewer import web as jweb
from goi_tpu_torch import interop
from goi_tpu_torch.app.orbit_ngp import NGPOrbitCamera
from goi_tpu_torch.app.session import QuerySession
from goi_tpu_torch.raster.render import RasterConfig, render
from goi_tpu_torch.viewer import app as tapp
from goi_tpu_torch.viewer import server as tserver
from goi_tpu_torch.viewer import web as tweb
from tests.conftest import make_random_scene
from tests.test_torch_core import to_torch_scene

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_OBJ, APE_DIM = 2, 16


def _decode(body: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(body)).convert("RGB"))


def _get(base, path):
    return urllib.request.urlopen(base + path, timeout=300)


def _post(base, payload):
    req = urllib.request.Request(
        base + "/op", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    return json.loads(urllib.request.urlopen(req, timeout=300).read())


def _close_u8(a, b):
    assert a.shape == b.shape
    assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1


def test_web_viewer_page_and_frames_match_jax():
    js = make_random_scene(n=100, seed=1)
    ts = to_torch_scene(js)
    calls = []

    def t_render(cam, prompt):
        calls.append((cam.width, cam.height, prompt, cam.world_view.device))
        return render(ts, cam, torch.zeros(3),
                      RasterConfig(max_instances=1 << 13))["render"]

    def j_render(cam, prompt):
        return jrender(js, cam, jnp.zeros(3),
                       JConfig(max_instances=1 << 13, tile_cap=256,
                               chunk=32))["render"]

    tv = tweb.WebViewer(t_render, host="127.0.0.1", port=0, device="cpu")
    jv = jweb.WebViewer(j_render, host="127.0.0.1", port=0)
    tv.start()
    jv.start()
    tb, jb = f"http://127.0.0.1:{tv.port}", f"http://127.0.0.1:{jv.port}"
    try:
        page = _get(tb, "/").read()
        assert b"goi_tpu_torch web viewer" in page and b"/frame?" in page
        for q, shape in (("", (48, 64, 3)), ("&scale=0.5", (32, 32, 3))):
            path = ("/frame?elev=10&azim=30&radius=4&w=64&h=48&prompt=chair"
                    + q)
            r = _get(tb, path)
            assert r.headers["Content-Type"] == "image/png"
            body = r.read()
            assert body[:8] == b"\x89PNG\r\n\x1a\n"
            img = _decode(body)
            assert img.shape == shape
            _close_u8(img, _decode(_get(jb, path).read()))
            assert calls[-1] == (shape[1], shape[0], "chair",
                                 torch.device("cpu"))
        with pytest.raises(urllib.error.HTTPError) as exc:
            _get(tb, "/nope")
        assert exc.value.code == 404
    finally:
        tv.stop()
        jv.stop()


@pytest.mark.parametrize("page", [tweb._PAGE, tapp._PAGE])
def test_pages_revoke_the_previous_object_url(page):
    """Each frame's blob URL is revoked when the next one replaces it
    (goi_tpu's pages never revoke theirs)."""
    assert page.count("URL.createObjectURL(") == 1
    revoke = page.index("if(url)URL.revokeObjectURL(url);")
    create = page.index("url=URL.createObjectURL(b);")
    assign = page.index("img.src=url;")
    assert revoke < create < assign
    assert "let az=0, el=15, r=3.5, busy=false, dirty=true, url=null;" in page
    assert "revokeObjectURL" not in japp._PAGE + jweb._PAGE


def test_encoders_and_u8_conversion():
    rng = np.random.default_rng(0)
    chw = rng.uniform(-0.2, 1.2, (3, 20, 30)).astype(np.float32)
    u8 = tweb._as_u8_hwc(chw)
    np.testing.assert_array_equal(u8, jweb._as_u8_hwc(chw))
    np.testing.assert_array_equal(tweb._as_u8_hwc(torch.as_tensor(chw)), u8)
    np.testing.assert_array_equal(tweb._as_u8_hwc(u8), u8)
    np.testing.assert_array_equal(_decode(tweb._to_png(chw)), u8)
    # JPEG on a smooth image (noise is its worst case)
    yy, xx = np.mgrid[0:20, 0:30] / 30.0
    smooth = np.stack([xx, yy, 0.5 * (xx + yy)]).astype(np.float32)
    jpeg = tweb._to_jpeg(smooth)
    assert jpeg[:2] == b"\xff\xd8"
    assert np.abs(_decode(jpeg).astype(int)
                  - tweb._as_u8_hwc(smooth).astype(int)).mean() < 3
    grey = tweb._as_u8_hwc(chw[:1])
    assert grey.shape == (20, 30, 3)


def _apps():
    """tests/test_query_web_app.py's scene: two separated objects with an
    identity-style decode chain, on both packages."""
    rng = np.random.default_rng(7)
    centers = np.array([[-0.8, 0, 0], [0.8, 0, 0]], np.float32)
    xyz = np.concatenate([c + rng.normal(0, 0.12, (150, 3))
                          .astype(np.float32) for c in centers])
    obj = np.repeat(np.arange(N_OBJ), 150)
    js = JScene.create(xyz, rng.uniform(0.2, 1, (300, 3)).astype(np.float32),
                       sh_degree=0, sem_dim=10,
                       scales=np.full(300, 0.06, np.float32))
    sems = np.zeros((300, 10), np.float32)
    sems[np.arange(300), obj] = 4.0
    js = js.replace(opacity=jnp.full_like(js.opacity, 1.8),
                    semantics=jnp.asarray(sems))
    q, _ = np.linalg.qr(rng.normal(0, 1, (APE_DIM, N_OBJ + 1)))
    basis = q.T.astype(np.float32)
    feats = basis - basis.mean(0, keepdims=True)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    lut = np.tile(feats[N_OBJ], (10, 1))
    lut[0], lut[1] = feats[0], feats[1]
    jsess = JSession(js, JDecoder(weights=[25.0 * jnp.eye(10)],
                                  biases=[None]), jnp.asarray(lut),
                     JConfig(max_instances=1 << 14, tile_cap=512, chunk=32,
                             backend="xla"),
                     sim_thresh=0.86, white_background=False)
    tsess = QuerySession(
        to_torch_scene(js),
        interop.decoder_from_numpy([25.0 * np.eye(10)], [None],
                                   device="cpu"),
        interop.lut_from_numpy(lut, device="cpu"),
        RasterConfig(max_instances=1 << 14), sim_thresh=0.86,
        white_background=False, device="cpu")
    text = {"left thing": feats[0] * 12.0, "right thing": feats[1] * 12.0}
    return jsess, tsess, text


def test_query_web_app_surface_matches_jax(tmp_path):
    jsess, tsess, text = _apps()
    ta = tapp.QueryWebApp(tsess, text_fn=lambda p: torch.as_tensor(text[p]),
                          host="127.0.0.1", port=0)
    ja = japp.QueryWebApp(jsess, text_fn=lambda p: text[p],
                          host="127.0.0.1", port=0)
    ta.start()
    ja.start()
    tb, jb = f"http://127.0.0.1:{ta.port}", f"http://127.0.0.1:{ja.port}"

    def both(payload):
        return _post(tb, payload), _post(jb, payload)

    try:
        page = _get(tb, "/").read()
        assert b"goi_tpu_torch query app" in page and b"/op" in page
        view = "/frame?elev=10&azim=20&radius=3.5&w=64&h=48"
        for mode in ("image", "depth", "alpha"):
            r = _get(tb, f"{view}&mode={mode}")
            assert r.headers["Content-Type"] == "image/png"
            _close_u8(_decode(r.read()),
                      _decode(_get(jb, f"{view}&mode={mode}").read()))
        r = _get(tb, f"{view}&fmt=jpeg&scale=0.5")
        assert r.headers["Content-Type"] == "image/jpeg"
        assert _decode(r.read()).shape == (32, 32, 3)

        t, j = both({"op": "set_text", "prompt": "left thing"})
        assert t == j and t["ok"]
        t, j = both({"op": "retrieve"})
        assert t == j and 100 <= t["retrieved"] <= 200, (t, j)
        _close_u8(_decode(_get(tb, view).read()),
                  _decode(_get(jb, view).read()))
        st = json.loads(_get(tb, "/state").read())
        assert st == {**json.loads(_get(jb, "/state").read()), "edit": None}
        assert st["num_valid"] == 300 and st["retrieved"] == t["retrieved"]

        xyz_before = tsess.scene.xyz.clone()
        for op in ({"op": "segment"}, {"op": "delete_view"},
                   {"op": "move", "delta": [0.2, 0, 0]}):
            t, j = both(op)
            assert t == j == {"ok": True}
        assert not torch.equal(tsess.scene.xyz, xyz_before)
        _close_u8(_decode(_get(tb, view).read()),
                  _decode(_get(jb, view).read()))
        assert both({"op": "reset"}) == ({"ok": True}, {"ok": True})
        assert torch.equal(tsess.scene.xyz, xyz_before)

        # grouping, with the query's own mask of the view
        oc = NGPOrbitCamera(64, 48, r=3.5, fovy=50.0)
        oc.orbit_to(10, 20)
        cam = oc.to_camera(device="cpu")
        with torch.no_grad():
            out = render(tsess.scene, cam, tsess.bg, tsess.raster_cfg)
        mask = (tsess.compute_similarity(out["semantics"].reshape(10, -1).T)
                > 0).reshape(48, 64).float().numpy()
        assert mask.sum() > 10
        cam_q = {"elev": 10, "azim": 20, "radius": 3.5, "w": 64, "h": 48}
        t, j = both(dict(op="group", mask=mask.tolist(), eps=0.3,
                         min_samples=5, **cam_q))
        assert t == j and 0 < t["kept"] <= 150, (t, j)

        t, j = both(dict(op="finetune", mask=mask.tolist(), max_epochs=1500,
                         **cam_q))
        assert t["ok"] and t["iou"] > 0.6 and np.isfinite(t["iou"]), (t, j)
        assert abs(t["iou"] - j["iou"]) < 0.05

        # a path video along two anchors (COLMAP c2w of the orbit views)
        c2w = np.linalg.inv(cam.world_view.numpy().astype(np.float64))
        oc.orbit_to(10, 60)
        c2w2 = np.linalg.inv(oc.to_camera(device="cpu").world_view.numpy()
                             .astype(np.float64))
        out = str(tmp_path / "path.mp4")
        vid = _post(tb, {"op": "video", "anchors": [c2w.tolist(),
                                                    c2w2.tolist()],
                         "w": 48, "h": 32, "steps": 3, "out": out})
        assert vid == {"ok": True, "frames": 4, "path": out}
        assert os.path.getsize(out) > 0

        t, j = both({"op": "retrieve"})
        assert t == j and t["retrieved"] > 0
        t, j = both({"op": "delete_perm"})
        assert t == j and t["num_valid"] < 300

        for name in ("edit_precompute", "edit_train", "nope"):
            for base in (tb, jb):
                with pytest.raises(urllib.error.HTTPError) as exc:
                    _post(base, {"op": name})
                assert exc.value.code == 500
                err = json.loads(exc.value.read())["error"]
                assert ("no edit session configured" in err) == \
                    name.startswith("edit")
        with pytest.raises(urllib.error.HTTPError) as exc:
            _get(tb, "/bogus")
        assert exc.value.code == 404
    finally:
        ta.stop()
        ja.stop()


def _exchange(gui, cam_msg: bytes, n_pixels: int, render_fn):
    """A client thread sends cam_msg; gui serves it; returns (flags,
    the client's reply bytes)."""
    got = {}

    def client():
        with socket.create_connection(("127.0.0.1", gui.port)) as s:
            s.sendall(cam_msg)
            buf = b""
            while len(buf) < n_pixels * 3 + 4:
                buf += s.recv(65536)
            vlen = int.from_bytes(buf[n_pixels * 3:n_pixels * 3 + 4],
                                  "little")
            while len(buf) < n_pixels * 3 + 4 + vlen:
                buf += s.recv(4096)
            got["reply"] = buf

    t = threading.Thread(target=client)
    t.start()
    flags = {}
    for _ in range(500):
        flags = gui.serve_step(render_fn, verify="test")
        if flags:
            break
        time.sleep(0.01)
    t.join(timeout=30)
    assert not t.is_alive()
    return flags, got["reply"]


def test_network_gui_loopback_matches_jax():
    tgui = tserver.NetworkGUI(port=0, device="cpu")
    jgui = jserver.NetworkGUI(port=0)
    tgui.port = tgui.listener.getsockname()[1]
    jgui.port = jgui.listener.getsockname()[1]
    oc = NGPOrbitCamera(8, 6, r=3.0, fovy=40.0)
    oc.orbit_to(15, 40)
    cam = oc.to_camera(device="cpu")
    msg = tserver.request_message(cam, scaling_modifier=0.5)
    seen = {}

    def fn(tag):
        def render_fn(c, sm):
            seen[tag] = (c, sm)
            return np.full((3, c.height, c.width), 0.5, np.float32)
        return render_fn

    try:
        tflags, treply = _exchange(tgui, msg, 48, fn("t"))
        jflags, jreply = _exchange(jgui, msg, 48, fn("j"))
    finally:
        tgui.close()
        jgui.listener.close()
        jgui.drop()
    assert tflags == jflags and tflags["scaling_modifier"] == 0.5
    assert treply == jreply and len(treply) == 48 * 3 + 4 + 4
    assert treply[-4:] == b"test"
    tc, jc = seen["t"][0], seen["j"][0]
    for k in ("world_view", "full_proj", "camera_center", "tan_fovx",
              "tan_fovy"):
        np.testing.assert_array_equal(getattr(tc, k).numpy(),
                                      np.asarray(getattr(jc, k)))
        # and the server rebuilds the client's camera bit for bit
        assert torch.equal(getattr(tc, k), getattr(cam, k)), k
    assert (tc.width, tc.height) == (8, 6)


def _model_dir(root):
    """A one-view COLMAP scene and a trained-scene triplet at iteration 1
    with an aligned prompt store; returns (model dir, store, camera info)."""
    from goi_tpu_torch.data import scene as triplet
    from goi_tpu_torch.data.readers import load_scene_info
    from goi_tpu_torch.examples.rehearsal import write_colmap
    from goi_tpu_torch.semantic.codebook import SemanticDecoder

    src, model = os.path.join(root, "scene"), os.path.join(root, "model")
    eye = np.array([0.6, 0.4, -4.0])
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    rw2c = np.stack([right, np.cross(fwd, right), fwd])
    write_colmap(src, [(rw2c, -rw2c @ eye, None)], 64, 48, 60.0, 60.0, [],
                 np.zeros((8, 3)), np.full((8, 3), 128, np.uint8))
    ts = to_torch_scene(make_random_scene(n=300, seed=4))
    gen = torch.Generator().manual_seed(0)
    decoder = SemanticDecoder.create(gen, dim_in=10, dim_out=30,
                                     device="cpu")
    lut = torch.as_tensor(np.random.default_rng(1).normal(
        0, 1, (30, 16)).astype(np.float32))
    triplet.save(os.path.join(model, "point_cloud", "iteration_1"), ts,
                 decoder, lut)
    with open(os.path.join(model, "cfg_args.json"), "w") as f:
        json.dump({"ModelParams": {"source_path": src, "sh_degree": 2}}, f)
    store = os.path.join(root, "prompts_aligned.npz")
    np.savez(store, thing=lut[3].numpy() * 5.0)
    return model, store, load_scene_info(src).train_cameras[0]


def test_viewer_cli_serves_a_frame_on_the_cpu(tmp_path):
    from goi_tpu_torch.data import scene as triplet
    from goi_tpu_torch.data.dataset import build_cameras
    from goi_tpu_torch.viewer.__main__ import main

    model, store, info = _model_dir(str(tmp_path))
    # without --device cpu it asks for the card, which is not here
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            main(["-m", model])
    proc = subprocess.Popen(
        [sys.executable, "-m", "goi_tpu_torch.viewer", "-m", model,
         "--port", "0", "--prompt_store", store, "--prompt", "thing",
         "--device", "cpu"], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": ROOT})
    try:
        port = None
        for line in proc.stdout:
            m = re.search(r"on 127\.0\.0\.1:(\d+)", line)
            if m:
                port = int(m.group(1))
                break
        assert port, proc.stderr.read()
        cam = build_cameras([info], device="cpu")[0]
        frame, verify = tserver.request_frame("127.0.0.1", port, cam)
    finally:
        proc.terminate()
        out, err = proc.communicate(timeout=60)
    assert proc.returncode == 0, err
    summary = [ln for ln in out.splitlines()
               if ln.startswith("[goi_tpu_torch.viewer] ")]
    assert len(summary) == 1, out
    summ = json.loads(summary[0].split(" ", 1)[1])
    assert summ["frames"] == 1 and summ["device"] == "cpu"
    assert verify == os.path.join(str(tmp_path), "scene")
    # the frame is render_view's of the same camera, query overlay on
    scene, decoder, lut = triplet.load(
        os.path.join(model, "point_cloud", "iteration_1"), device="cpu")
    sess = QuerySession(scene, decoder, lut,
                        RasterConfig(max_instances=summ["budget"]),
                        white_background=False, device="cpu")
    with np.load(store) as s:
        sess.set_text(s["thing"])
    want = sess.render_view(cam, as_u8=True)
    assert frame.shape == (48, 64, 3)
    _close_u8(frame, want)
    assert (want != 0).any()
