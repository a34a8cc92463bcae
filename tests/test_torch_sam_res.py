"""goi_tpu_torch's SAM, the jax.image.resize counterpart and the RES
providers against goi_tpu: the image encoder (windowed blocks with
padding, global blocks with decomposed rel-pos), the prompt encoder, the
mask decoder (its ConvTranspose2d against jax.lax.conv_transpose), the
predictor's masks, rerank_keep, TorchRESProvider's union mask,
FileRESProvider, the checkpoint contract at ViT-B/L/H, and the query
app's OSH fine-tune with its mask from res_fn. The same seeded numpy
params (tests/test_grounding.py's draws) go through both packages
(interop carries them across). Tolerances
are those of tests/test_sam_jax.py: encoder, decoder and IoU atol 2e-4,
prompt embeddings 1e-5; masks equal away from pixels whose logit is
within 1e-3 of 0. The resize is held to jax.image.resize at atol 1.5e-4
on images in [0, 1]: JAX computes its sample positions in float32, so
near 1000 pixels they carry up to an ulp (1.2e-4) into the weights; the
port's weights are the formula's in float64, rounded to float32 (held
to a float64 evaluation at 1e-7)."""

import json
import os
import urllib.error
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from goi_tpu.query import grounding as jg
from goi_tpu.query import res as jres
from goi_tpu.query import sam as jsam
from goi_tpu.query.bert import BertTokenizer as JTok
from goi_tpu_torch import interop
from goi_tpu_torch.query import grounding as tg
from goi_tpu_torch.query import res as tres
from goi_tpu_torch.query import sam as tsam
from goi_tpu_torch.query.bert import BertTokenizer as TTok, make_test_vocab
from goi_tpu_torch.utils import image as timage
from goi_tpu_torch.viewer import app as tapp
from tests.test_torch_grounding import _rand_params
from tests.test_torch_viewer import _apps, _get, _post

torch.set_num_threads(1)

TINY = dict(embed_dim=32, depth=3, num_heads=2, global_attn=(1,), window=4,
            img_size=64, patch=8, prompt_dim=16, decoder_mlp=32)
# grid 10 at window 4: the windowed blocks pad 10 -> 12 (ViT-H pads its
# 64 -> 70 at window 14), the global block looks its rel-pos up at 10
PADDED = dict(TINY, img_size=80)
BOXES = np.array([[5, 5, 40, 30], [10, 2, 60, 47], [0, 20, 30, 47]],
                 np.float32)


def _sam_pair(kw, seed=0):
    jcfg, tcfg = jsam.SAMConfig(**kw), tsam.SAMConfig(**kw)
    params = _rand_params(jsam.sam_param_shapes(jcfg), seed)
    return (jsam.SamJax(params, jcfg),
            tsam.SamTorch(interop.sam_from_numpy(params, tcfg,
                                                 device="cpu")))


@pytest.fixture(scope="module")
def tiny():
    return _sam_pair(TINY)


def _image(h=48, w=64, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (h, w, 3)) \
        .astype(np.float32)


@pytest.mark.parametrize("kw", [TINY, PADDED], ids=["grid8", "grid10_padded"])
def test_image_encoder_matches_jax(kw):
    js, ts = _sam_pair(kw, seed=1)
    x = np.random.default_rng(2).normal(
        0, 1, (1, 3, kw["img_size"], kw["img_size"])).astype(np.float32)
    want = jax.jit(lambda p, v: jsam.image_encoder(p, js.cfg, v))(
        js.params, jnp.asarray(x))
    with torch.no_grad():
        got = ts.model.image_encoder(torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


def test_prompt_encoder_and_mask_decoder_match_jax(tiny):
    js, ts = tiny
    p, cfg, pe = js.params, js.cfg, ts.model.prompt_encoder
    rng = np.random.default_rng(3)
    boxes = rng.uniform(0, 64, (2, 4)).astype(np.float32)
    pts = rng.uniform(0, 64, (2, 3, 2)).astype(np.float32)
    labels = np.array([[1, 0, -1], [0, 1, 1]], np.int32)
    with torch.no_grad():
        sparse = pe.encode_boxes(torch.as_tensor(boxes))
        np.testing.assert_allclose(
            sparse.numpy(),
            np.asarray(jsam.encode_boxes(p, cfg, jnp.asarray(boxes))),
            atol=1e-5)
        np.testing.assert_allclose(
            pe.encode_points(torch.as_tensor(pts),
                             torch.as_tensor(labels)).numpy(),
            np.asarray(jsam.encode_points(p, cfg, jnp.asarray(pts),
                                          jnp.asarray(labels))), atol=1e-5)
        dpe = pe.dense_pe()
        np.testing.assert_allclose(dpe.numpy(),
                                   np.asarray(jsam.dense_pe(p, cfg)),
                                   atol=1e-5)
        np.testing.assert_array_equal(
            pe.no_mask(2).numpy(), np.asarray(jsam.no_mask_embed(p, cfg, 2)))
        emb = rng.normal(0, 1, (2, 16, cfg.grid, cfg.grid)).astype(np.float32)
        for multimask in (False, True):
            m, iou = ts.model.mask_decoder(torch.as_tensor(emb), dpe, sparse,
                                           pe.no_mask(2), multimask)
            jm, jiou = _jax_decoder(
                p, cfg, jnp.asarray(emb), jsam.dense_pe(p, cfg),
                jsam.encode_boxes(p, cfg, jnp.asarray(boxes)),
                jsam.no_mask_embed(p, cfg, 2), multimask)
            assert m.shape == (2, 3 if multimask else 1) + (4 * cfg.grid,) * 2
            np.testing.assert_allclose(m.numpy(), np.asarray(jm), atol=2e-4)
            np.testing.assert_allclose(iou.numpy(), np.asarray(jiou),
                                       atol=2e-4)


def test_conv_transpose_matches_jax():
    """jax.lax.conv_transpose(transpose_kernel=True) on torch's native
    (Cin, Cout, 2, 2) weight is nn.ConvTranspose2d (the JAX comment's
    flipped kernel)."""
    rng = np.random.default_rng(4)
    w = rng.normal(size=(6, 4, 2, 2)).astype(np.float32)
    b = rng.normal(size=(4,)).astype(np.float32)
    x = rng.normal(size=(2, 6, 5, 7)).astype(np.float32)
    want = jsam._deconv2x({"d.weight": jnp.asarray(w),
                           "d.bias": jnp.asarray(b)}, "d", jnp.asarray(x))
    conv = torch.nn.ConvTranspose2d(6, 4, 2, stride=2)
    interop.load_flat_params(conv, {"weight": w, "bias": b})
    with torch.no_grad():
        got = conv(torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("q_k", [(5, 5), (8, 8)])
def test_get_rel_pos_matches_jax(q_k):
    """The rel-pos lookup, with the "linear" table resize when the
    table's length differs from 2*max(q,k)-1."""
    table = np.random.default_rng(5).normal(size=(7, 6)).astype(np.float32)
    got = tsam._get_rel_pos(*q_k, torch.as_tensor(table))
    want = jsam._get_rel_pos(*q_k, jnp.asarray(table))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("src, dst", [
    ((968, 1296, 3), (800, 800, 3)),       # GroundingDINO's input
    ((968, 1296, 3), (765, 1024, 3)),      # SAM's longest side
    ((2, 1, 256, 256), (2, 1, 1024, 1024)),  # SAM's mask upscale
    ((1, 1, 765, 1024), (1, 1, 968, 1296)),  # back to the view
], ids=["dino_800", "sam_1024", "masks_256_1024", "masks_to_view"])
def test_resize_linear_matches_jax(src, dst):
    x = np.random.default_rng(6).uniform(0, 1, src).astype(np.float32)
    got = timage.resize_linear(torch.as_tensor(x), dst).numpy()
    want = np.asarray(jax.image.resize(jnp.asarray(x), dst, "bilinear"))
    np.testing.assert_allclose(got, want, atol=1.5e-4)
    # the port's per-axis weights are the formula's (float64 here)
    for d, (n_in, n_out) in enumerate(zip(src, dst)):
        if n_in == n_out:
            continue
        inv = n_in / n_out
        s = (np.arange(n_out) + 0.5) * inv - 0.5
        wt = np.maximum(0, 1 - np.abs(s[None] - np.arange(n_in)[:, None])
                        / max(inv, 1.0))
        wt = wt / wt.sum(0, keepdims=True)
        np.testing.assert_allclose(
            timage._linear_weights(n_in, n_out, "cpu").numpy(), wt,
            rtol=1e-6, atol=1e-7)
    # F.interpolate is not this resize: it does not antialias
    if dst[0] < src[0]:
        plain = torch.nn.functional.interpolate(
            torch.as_tensor(x).permute(2, 0, 1)[None], size=dst[:2],
            mode="bilinear", align_corners=False)[0].permute(1, 2, 0)
        assert np.abs(plain.numpy() - want).max() > 1e-2


_jax_decoder = jax.jit(jsam.mask_decoder, static_argnums=(1, 6))


@partial(jax.jit, static_argnums=(1, 4, 5))
def _jax_logits(p, cfg, emb, boxes, hw, new_hw):
    (h, w), (nh, nw) = hw, new_hw
    scale = jnp.asarray([nw / w, nh / h, nw / w, nh / h], jnp.float32)
    sparse = jsam.encode_boxes(p, cfg, boxes * scale)
    m, _ = jsam.mask_decoder(p, cfg, jnp.broadcast_to(
        emb, (boxes.shape[0],) + emb.shape[1:]), jsam.dense_pe(p, cfg),
        sparse, jsam.no_mask_embed(p, cfg, boxes.shape[0]), False)
    b, n = m.shape[:2]
    m = jax.image.resize(m, (b, n, cfg.img_size, cfg.img_size),
                         "bilinear")[:, :, :nh, :nw]
    return jax.image.resize(m, (b, n, h, w), "bilinear")


def _jax_mask_logits(js, boxes):
    """SamJax.predict_boxes's logits before the threshold."""
    return np.asarray(_jax_logits(js.params, js.cfg, js._emb,
                                  jnp.asarray(boxes), js._orig_hw,
                                  js._new_hw))


@pytest.mark.parametrize("h_w", [(48, 64), (80, 60)])
def test_predictor_masks_equal_jax(tiny, h_w):
    js, ts = tiny
    img = _image(*h_w)
    js.set_image(img)
    ts.set_image(img)
    np.testing.assert_allclose(ts._emb.numpy(), np.asarray(js._emb),
                               atol=2e-4)
    boxes = BOXES * np.float32(min(h_w) / 48)
    jm, jiou = js.predict_boxes(boxes)
    tm, tiou = ts.predict_boxes(boxes)
    assert tm.shape == jm.shape == (3, 1) + h_w and tm.dtype == bool
    np.testing.assert_allclose(tiou, jiou, atol=2e-4)
    near = np.abs(_jax_mask_logits(js, boxes)) < 1e-3
    assert (tm != jm)[~near].sum() == 0
    assert 0 < tm.mean() < 1
    with pytest.raises(RuntimeError, match="set_image"):
        tsam.SamTorch(ts.model).predict_boxes(boxes)


def test_param_shapes_match_jax_for_vit_b_l_h():
    """The official checkpoints' shapes (goi_tpu's table, validated
    against the sam_vit_* state_dicts) are SAM's state_dict at ViT-B, -L
    and -H, built on the meta device: nothing allocated."""
    for name in ("SAM_VIT_B", "SAM_VIT_L", "SAM_VIT_H"):
        tcfg = getattr(tsam, name)
        shapes = tsam.sam_param_shapes(tcfg)
        assert shapes == jsam.sam_param_shapes(getattr(jsam, name)), name
        model = tsam.SAM(tcfg, device="meta")
        assert {k: tuple(v.shape)
                for k, v in model.state_dict().items()} == shapes, name
    assert 640e6 < sum(v.numel() for v in model.parameters()) < 642e6


def test_load_sam_params_and_init(tmp_path):
    kw = dict(TINY, depth=2)
    model = tsam.init_sam_(tsam.SAM(tsam.SAMConfig(**kw), device="cpu"),
                           torch.Generator().manual_seed(0))
    sd = model.state_dict()
    assert torch.equal(sd["image_encoder.neck.1.weight"], torch.ones(16))
    assert torch.equal(sd["mask_decoder.transformer.layers.0.norm1.bias"],
                       torch.zeros(16))
    assert abs(float(sd["image_encoder.pos_embed"].std()) - 0.02) < 0.004
    path = tmp_path / "sam.pth"
    torch.save(sd, path)
    loaded = tsam.load_sam_params(str(path))
    assert loaded.keys() == jsam.sam_param_shapes(jsam.SAMConfig(**kw)).keys()
    again = interop.sam_from_numpy(loaded, tsam.SAMConfig(**kw), device="cpu")
    assert all(torch.equal(again.state_dict()[k], v) for k, v in sd.items())


# ---------------------------------------------------------------------------
# RES providers
# ---------------------------------------------------------------------------

def test_rerank_keep_equal_jax():
    rng = np.random.default_rng(8)
    cases = [np.asarray([1.0, 0.995, 0.992, 0.9, 0.1]),
             np.asarray([0.5, 1.0, 0.999]), np.asarray([1.0, 0.995, 0.6]),
             np.asarray([1.0])] + [rng.uniform(0.5, 1, 9) for _ in range(20)]
    for p in cases:
        for a, b in ((0.99, 0.9), (0.5, 0.9), (0.8, 0.8)):
            np.testing.assert_array_equal(tres.rerank_keep(p, a, b),
                                          jres.rerank_keep(p, a, b))
    np.testing.assert_array_equal(
        tres.rerank_keep(np.asarray([1.0, 0.995, 0.992, 0.9, 0.1]),
                         0.99, 0.9), [0, 1, 2])


@pytest.fixture(scope="module")
def res_pair(tiny):
    js, ts = tiny
    params = _rand_params(jg.grounding_param_shapes(jg.GDINO_TINY_TEST), 0)
    vocab = make_test_vocab(["the", "red", "chair"])
    jd = jg.GroundingDINOJax(params, jg.GDINO_TINY_TEST, JTok(vocab))
    td = tg.GroundingDINOTorch(
        interop.grounding_from_numpy(params, tg.GDINO_TINY_TEST,
                                     device="cpu"), TTok(vocab))
    return jd, js, td, ts


@pytest.fixture
def published_input(monkeypatch):
    """goi_tpu's detector squashes a view to its square input; the port
    resizes it by the published rule (`input_hw`, the aspect kept). So
    that both packages are fed the same tensor, goi_tpu's resize of the
    view to its square goes to the port's (h, w) instead, through
    jax.image.resize as before (SAM's resizes are not square, and
    pass)."""
    real = jax.image.resize

    def resize(x, shape, *a, **kw):
        s = tg.GDINO_TINY_TEST.img_size
        if x.ndim == 3 and tuple(shape) == (s, s, 3):
            shape = tg.input_hw(x.shape[0], x.shape[1], s,
                                tg.GDINO_TINY_TEST.max_size) + (3,)
        return real(x, shape, *a, **kw)

    monkeypatch.setattr(jax.image, "resize", resize)


def test_res_provider_mask_equal_jax(res_pair, published_input):
    jd, js, td, ts = res_pair
    img = _image()
    _, scores, _ = jd.predict(img, "the red chair", box_threshold=0.0)
    s = np.sort(scores)[::-1]
    thr = float(s[3] + s[4]) / 2          # four boxes reach SAM
    got = tres.TorchRESProvider(td, ts, box_threshold=thr).predict_mask(
        img, "the red chair")
    want = jres.JaxRESProvider(jd, js, box_threshold=thr).predict_mask(
        img, "the red chair")
    assert got is not None and got.shape == img.shape[:2]
    assert got.dtype == bool and got.any()
    np.testing.assert_array_equal(got, want)
    # no box passes: no mask
    assert tres.TorchRESProvider(td, ts, box_threshold=1.1).predict_mask(
        img, "the red chair") is None


def test_file_res_provider(tmp_path):
    os.makedirs(tmp_path / "res" / "sofa")
    Image.fromarray((np.eye(16) * 255).astype(np.uint8)).save(
        tmp_path / "res" / "sofa" / "view0.png")
    img = np.zeros((32, 24, 3), np.float32)
    got = tres.FileRESProvider(str(tmp_path / "res"))
    want = jres.FileRESProvider(str(tmp_path / "res"))
    m = got.predict_mask(img, "sofa", "view0")
    assert m is not None and m.shape == (32, 24) and m.any()
    np.testing.assert_array_equal(m, want.predict_mask(img, "sofa", "view0"))
    assert got.predict_mask(img, "chair", "view0") is None


def test_app_finetune_takes_its_mask_from_res_fn(res_pair):
    """The query app's OSH fine-tune with no client mask: the mask comes
    from res_fn (TorchRESProvider.predict_mask) on the rendered view of
    the current prompt, then the hinge fit runs; a provider that finds no
    box answers "RES returned no mask"."""
    _, _, td, ts = res_pair
    _, sess, text = _apps()
    prov = tres.TorchRESProvider(td, ts, box_threshold=0.0)
    seen = []

    def res_fn(img, prompt):
        mask = prov.predict_mask(img, prompt)
        seen.append((img, prompt, mask))
        return mask

    app = tapp.QueryWebApp(sess, text_fn=lambda p: torch.as_tensor(text[p]),
                           res_fn=res_fn, host="127.0.0.1", port=0)
    app.start()
    base = f"http://127.0.0.1:{app.port}"
    try:
        _post(base, {"op": "set_text", "prompt": "left thing"})
        cam_q = {"elev": 10, "azim": 20, "radius": 3.5, "w": 64, "h": 48}
        ft = _post(base, dict(op="finetune", max_epochs=50, **cam_q))
        assert ft["ok"] and np.isfinite(ft["iou"]) and ft["epochs"] >= 0
        (img, prompt, mask), = seen
        assert prompt == "left thing" and img.shape == (48, 64, 3)
        np.testing.assert_array_equal(
            img, sess.render_view(app._cam(cam_q), overlay=False))
        assert mask.shape == (48, 64) and mask.any()
        assert json.loads(_get(base, "/state").read())["osh_finetuned"]
        prov.box_threshold = 1.1
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(base, dict(op="finetune", max_epochs=5, **cam_q))
        assert "RES returned no mask" in json.loads(exc.value.read())["error"]
    finally:
        app.stop()

