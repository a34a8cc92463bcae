"""goi_tpu_torch query path against goi_tpu: the decoder and its pickle,
the codebook decode and similarities, OSH, the turbo overlay, and every
branch and mode of QuerySession.render_view plus the retrieval/edit
methods."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goi_tpu.app.session import QuerySession as JSession
from goi_tpu.core.ply import save_gaussians_ply as j_save_ply
from goi_tpu.core.ply import load_gaussians_ply as j_load_ply
from goi_tpu.query import osh as josh
from goi_tpu.query import similarity as jsim
from goi_tpu.raster import RasterConfig as JConfig
from goi_tpu.semantic.codebook import SemanticDecoder as JDecoder
from goi_tpu.utils import image as jimage
from goi_tpu_torch import interop
from goi_tpu_torch.app.session import QuerySession as TSession
from goi_tpu_torch.data import scene as tdata
from goi_tpu_torch.query import osh as tosh
from goi_tpu_torch.query import similarity as tsim
from goi_tpu_torch.raster.render import RasterConfig
from goi_tpu_torch.semantic.codebook import SemanticDecoder as TDecoder
from goi_tpu_torch.utils import image as timage
from tests.conftest import make_random_scene, make_test_camera
from tests.test_torch_core import to_torch_camera, to_torch_scene

torch.set_num_threads(1)

JCFG = JConfig(max_instances=1 << 13, tile_cap=256, chunk=32,
               backend="pallas")
TCFG = RasterConfig(max_instances=1 << 13)


def _np(x):
    return np.array(x)


def test_decoder_pickle_across_packages(tmp_path):
    jdec = JDecoder.create(jax.random.PRNGKey(0), dim_in=10, dim_hidden=32,
                           dim_out=300, num_layer=2, norm=True)
    p = str(tmp_path / "semantic_MLP.pt")
    jdec.save(p)
    tdec = TDecoder.load(p, device="cpu")
    x = np.random.default_rng(0).normal(0, 1, (64, 10)).astype(np.float32)
    np.testing.assert_allclose(tdec(torch.as_tensor(x)).detach().numpy(),
                               _np(jdec(jnp.asarray(x))), rtol=1e-5,
                               atol=1e-6)
    q = str(tmp_path / "torch.pt")
    tdec.save(q)
    back = JDecoder.load(q)
    for a, b in zip(back.weights + back.biases, jdec.weights + jdec.biases):
        np.testing.assert_array_equal(_np(a), _np(b))
    assert back.norm_output is True
    tdec2 = interop.decoder_from_numpy([_np(w) for w in jdec.weights],
                                       [_np(b) for b in jdec.biases],
                                       norm_output=True, device="cpu")
    assert torch.equal(tdec2(torch.as_tensor(x)), tdec(torch.as_tensor(x)))
    gen = torch.Generator().manual_seed(0)
    made = TDecoder.create(gen, dim_in=10, dim_out=300, device="cpu")
    bound = float(np.sqrt(6.0 / 310))
    assert made.weights[0].shape == (300, 10)
    assert float(made.weights[0].detach().abs().max()) <= bound


def test_triplet_round_trip_across_packages(tmp_path):
    js = make_random_scene(n=80, seed=1)
    jdec = JDecoder.create(jax.random.PRNGKey(1), dim_in=10, dim_out=30)
    lut = np.random.default_rng(1).normal(0, 1, (30, 16)).astype(np.float32)
    j_save_ply(str(tmp_path / tdata.PLY), js)
    jdec.save(str(tmp_path / tdata.DECODER))
    np.save(str(tmp_path / tdata.LUT), lut)
    ts, tdec, tlut = tdata.load(str(tmp_path), device="cpu")
    np.testing.assert_array_equal(tlut.numpy(), lut)
    np.testing.assert_array_equal(ts.xyz.numpy(), _np(js.xyz))
    out = tmp_path / "port"
    tdata.save(str(out), ts, tdec, tlut)
    back = j_load_ply(str(out / tdata.PLY))
    np.testing.assert_array_equal(_np(back.semantics), _np(js.semantics))
    np.testing.assert_array_equal(np.load(str(out / tdata.LUT)), lut)
    JDecoder.load(str(out / tdata.DECODER))


def _codes_gap(logits):
    top2 = np.sort(logits, axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


def test_decode_and_similarities_match_jax():
    rng = np.random.default_rng(2)
    jdec = JDecoder.create(jax.random.PRNGKey(2), dim_in=10, dim_out=300)
    tdec = interop.decoder_from_numpy([_np(w) for w in jdec.weights],
                                      [_np(b) for b in jdec.biases],
                                      device="cpu")
    lut = rng.normal(0, 1, (300, 256)).astype(np.float32)
    sem = rng.normal(0, 1, (2000, 10)).astype(np.float32)
    jf = _np(jsim.decode_semantic_features(jdec, jnp.asarray(lut),
                                           jnp.asarray(sem)))
    tf = tsim.decode_semantic_features(
        tdec, interop.lut_from_numpy(lut, device="cpu"),
        torch.as_tensor(sem)).detach().numpy()
    # codes agree except where the top-2 logits lie within 1e-5
    ok = _codes_gap(_np(jdec(jnp.asarray(sem)))) > 1e-5
    assert ok.mean() > 0.99
    np.testing.assert_allclose(tf[ok], jf[ok], rtol=1e-6, atol=1e-6)

    text = rng.normal(0, 1, 256).astype(np.float32)
    text /= np.linalg.norm(text)
    for ls in (0.0, -1.5):
        np.testing.assert_allclose(
            tsim.ape_similarity(torch.as_tensor(jf), torch.as_tensor(text),
                                log_scale=ls).numpy(),
            _np(jsim.ape_similarity(jnp.asarray(jf), jnp.asarray(text),
                                    log_scale=ls)), rtol=1e-6, atol=1e-6)
    canon = rng.normal(0, 1, (4, 256)).astype(np.float32)
    np.testing.assert_allclose(
        tsim.clip_relevancy(torch.as_tensor(jf), torch.as_tensor(text),
                            torch.as_tensor(canon)).numpy(),
        _np(jsim.clip_relevancy(jnp.asarray(jf), jnp.asarray(text),
                                jnp.asarray(canon))), rtol=1e-5, atol=1e-6)

    jst = josh.osh_init(jnp.asarray(text))
    tst = tosh.osh_init(torch.as_tensor(text))
    np.testing.assert_allclose(tst.bias.numpy(), _np(jst.bias), rtol=1e-6)
    np.testing.assert_allclose(
        tosh.osh_predict(tst, torch.as_tensor(jf)).numpy(),
        _np(josh.osh_predict(jst, jnp.asarray(jf))), rtol=1e-5, atol=1e-5)
    assert tosh.INPUT_SCALE == josh.INPUT_SCALE


def test_turbo_and_clip_color_match_jax():
    rng = np.random.default_rng(3)
    sim = rng.uniform(0.8, 1.0, 48).astype(np.float32)
    bgm = rng.uniform(0, 1, 48) > 0.7
    np.testing.assert_array_equal(timage._turbo_table(),
                                  jimage._turbo_table())
    np.testing.assert_array_equal(
        timage.turbo_colormap(torch.as_tensor(sim)).numpy(),
        _np(jimage.turbo_colormap(jnp.asarray(sim))))
    for res, col in ((False, True), (True, True), (False, False)):
        th, ta = timage.clip_color(torch.as_tensor(sim),
                                   torch.as_tensor(bgm), 6, 8,
                                   res_finetuned=res, coloring=col)
        jh, ja = jimage.clip_color(sim, bgm, 6, 8, res_finetuned=res,
                                   coloring=col)
        np.testing.assert_allclose(np.asarray(th), np.asarray(jh),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(np.asarray(ta), np.asarray(ja))
    assert timage.compute_mask_ratio(bgm, ~bgm) == \
        jimage.compute_mask_ratio(bgm, ~bgm) == 0


def _sessions(seed=0):
    """tests/test_app_edit.py's session: first half of the Gaussians
    carries code 0, the second half code 1; text ~ LUT row 0."""
    js = make_random_scene(n=200, seed=seed)
    sems = np.zeros((js.capacity, 10), np.float32)
    sems[:100, 0] = 3.0
    sems[100:, 1] = 3.0
    js = js.replace(semantics=jnp.asarray(sems))
    jdec = JDecoder(weights=[jnp.eye(10) * 4.0], biases=[jnp.zeros(10)])
    lut = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (10, 64)))
    text = lut[0] / np.linalg.norm(lut[0]) * 10.0
    jsess = JSession(js, jdec, jnp.asarray(lut), JCFG, sim_thresh=0.86)
    tsess = TSession(to_torch_scene(js),
                     interop.decoder_from_numpy([np.eye(10) * 4.0],
                                                [np.zeros(10)],
                                                device="cpu"),
                     interop.lut_from_numpy(lut, device="cpu"), TCFG,
                     sim_thresh=0.86, device="cpu")
    jsess.set_text(jnp.asarray(text))
    tsess.set_text(text)
    return jsess, tsess


def _same_frame(jsess, tsess, cam, **kw):
    jimg = jsess.render_view(cam, **kw)
    timg = tsess.render_view(to_torch_camera(cam), **kw)
    assert timg.shape == jimg.shape and timg.dtype == jimg.dtype
    if kw.get("as_u8"):
        diff = np.abs(timg.astype(np.int32) - jimg.astype(np.int32))
        assert diff.max() <= 1
    else:
        np.testing.assert_allclose(timg, jimg, rtol=5e-5, atol=5e-5)
    return timg


@pytest.mark.parametrize("mode,overlay", [
    ("image", True), ("image", False), ("depth", True), ("alpha", True)])
@pytest.mark.parametrize("as_u8", [False, True])
def test_render_view_branches_and_modes_match_jax(mode, overlay, as_u8):
    jsess, tsess = _sessions()
    cam = make_test_camera(width=48, height=32)
    img = _same_frame(jsess, tsess, cam, mode=mode, overlay=overlay,
                      as_u8=as_u8)
    assert img.shape == (32, 48, 3)


def test_render_view_osh_branch_and_no_text_match_jax():
    jsess, tsess = _sessions()
    cam = make_test_camera(width=48, height=32)
    jsess.osh = josh.osh_init(jsess.text_tokens)
    tsess.osh = interop.osh_from_numpy(_np(jsess.osh.weight),
                                       _np(jsess.osh.bias), device="cpu")
    jsess.res_finetuned = tsess.res_finetuned = True
    _same_frame(jsess, tsess, cam)
    _same_frame(jsess, tsess, cam, as_u8=True)
    jsess.res_finetuned = tsess.res_finetuned = False
    jsess.text_tokens = tsess.text_tokens = None
    _same_frame(jsess, tsess, cam, scaling_modifier=0.9)
    assert float(tsess.compute_similarity(
        tsess.scene.get_semantics()).abs().sum()) == 0.0


def test_retrieval_and_edits_match_jax():
    jsess, tsess = _sessions()
    cam = make_test_camera(width=48, height=32)
    np.testing.assert_array_equal(tsess.retrieve(), jsess.retrieve())
    for op in ("segment", "delete_view"):
        getattr(jsess, op)()
        getattr(tsess, op)()
        _same_frame(jsess, tsess, cam, overlay=False)
    jsess.gs_index = tsess.gs_index = None
    jsess.move([0.5, 0.0, 0.0])
    tsess.move([0.5, 0.0, 0.0])
    np.testing.assert_array_equal(tsess.motion, jsess.motion)
    _same_frame(jsess, tsess, cam, overlay=False)
    jsess.reset_motion()
    tsess.reset_motion()
    np.testing.assert_allclose(tsess.scene.xyz.numpy(),
                               _np(jsess.scene.xyz), atol=1e-6)
    jsess.delete_permanently()
    tsess.delete_permanently()
    np.testing.assert_array_equal(tsess.scene.valid.numpy(),
                                  _np(jsess.scene.valid))
    assert int(tsess.scene.num_valid) <= 110
    _same_frame(jsess, tsess, cam)
