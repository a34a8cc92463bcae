"""goi_tpu_torch's GroundingDINO towers against goi_tpu: BERT and its
WordPiece tokenizer and sub-sentence masks, Swin (padding and shifted
windows), multi-scale deformable attention (also against F.grid_sample,
an independent oracle), the whole detector, its predictor and its
checkpoint contract. The same seeded numpy params (tests/test_grounding.py's
draws, norms and biases away from their init) go through both packages
(interop carries them across). Tolerances are those of the JAX
tests each case mirrors (tests/test_grounding.py,
tests/test_deform_attn.py): BERT atol 2e-5 / rtol 1e-4, Swin atol 2e-4 /
rtol 1e-3, the deformable core atol 2e-5, boxes and logits atol 2e-3 /
rtol 1e-2."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from goi_tpu.query import bert as jbert
from goi_tpu.query import deform_attn as jda
from goi_tpu.query import grounding as jg
from goi_tpu.query import swin as jswin
from goi_tpu_torch import interop
from goi_tpu_torch.query import bert as tbert
from goi_tpu_torch.query import deform_attn as tda
from goi_tpu_torch.query import grounding as tg
from goi_tpu_torch.query import swin as tswin

torch.set_num_threads(1)

MANIFEST = os.path.join(os.path.dirname(__file__), "golden",
                        "gdino_swint_manifest.json")
WORDS = ["the", "red", "chair", "sofa", "table", "run", "##ning", "un",
         "##aff", "##able", "a", "b"]
CAPTION = "the red chair"


def _rand_params(shapes, seed=0):
    """tests/test_grounding.py's draws: biases small, norms near one."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, shp in sorted(shapes.items()):
        if k.endswith(".bias"):
            out[k] = rng.normal(0, 0.02, shp).astype(np.float32)
        elif ("norm" in k.lower() or "gamma" in k) and len(shp) == 1:
            out[k] = rng.uniform(0.5, 1.5, shp).astype(np.float32)
        else:
            fan = shp[-1] if len(shp) >= 2 else shp[0]
            out[k] = rng.normal(0, 1 / np.sqrt(fan), shp).astype(np.float32)
    return out


def _strip(params, prefix):
    return {k[len(prefix):]: v for k, v in params.items()
            if k.startswith(prefix)}


def _t(a):
    return torch.as_tensor(np.array(a))


# ---------------------------------------------------------------------------
# BERT, tokenizer, masks
# ---------------------------------------------------------------------------

def test_bert_matches_jax():
    cfg = tbert.BERT_TINY_TEST
    params = _rand_params(jbert.bert_param_shapes(jbert.BERT_TINY_TEST), 5)
    model = interop.load_flat_params(tbert.BertModel(cfg, device="cpu"),
                                     _strip(params, "bert."))
    rng = np.random.default_rng(1)
    ids = rng.integers(0, cfg.vocab_size, (2, 11)).astype(np.int32)
    # block-diagonal 3D mask + restarting position ids (the bertwarper
    # contract)
    attn = np.zeros((2, 11, 11), bool)
    attn[:, :5, :5] = True
    attn[:, 5:, 5:] = True
    pos = np.concatenate([np.arange(5), np.arange(6)])[None].repeat(2, 0)
    want = jbert.bert_forward({k: jnp.asarray(v) for k, v in params.items()},
                              jbert.BERT_TINY_TEST, jnp.asarray(ids),
                              jnp.asarray(attn), jnp.asarray(pos))
    with torch.no_grad():
        got = model(_t(ids), _t(attn), _t(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-4)


def test_wordpiece_and_special_token_masks_equal_jax():
    vocab = jbert.make_test_vocab(WORDS)
    assert tbert.make_test_vocab(WORDS) == vocab
    jt, tt = jbert.BertTokenizer(vocab), tbert.BertTokenizer(vocab)
    rows = []
    for text in ("The red chair.", "unaffable running?", "xyzzy chair",
                 "THE   RED\tsofa . a table", "Ünaffable, b"):
        ids = tt.encode(text)
        assert ids == jt.encode(text), text
        assert tt.decode(ids[1:-1]) == jt.decode(ids[1:-1])
        rows.append(ids)
    assert tt.special_ids() == jt.special_ids()
    n = max(map(len, rows))
    mat = np.asarray([r + [0] * (n - len(r)) for r in rows])
    for a, b in zip(tbert.special_token_masks(mat, tt.special_ids()),
                    jbert.special_token_masks(mat, jt.special_ids())):
        if isinstance(a, list):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("text_pad", [8, 16])
def test_prep_text_equal_jax(text_pad):
    """The forced '. [SEP]' tail of a truncated caption, the sub-sentence
    mask, the restarting position ids and the padding mask."""
    vocab = jbert.make_test_vocab(WORDS)
    jdet = object.__new__(jg.GroundingDINOJax)
    jdet.tokenizer = jbert.BertTokenizer(vocab)
    jdet.cfg = jg.GroundingConfig(text_pad=text_pad)
    tdet = object.__new__(tg.GroundingDINOTorch)
    tdet.tokenizer = tbert.BertTokenizer(vocab)
    tdet.cfg = tg.GroundingConfig(text_pad=text_pad)
    for cap in ("the red chair . the sofa . the red table", "the red chair"):
        got, want = tdet._prep_text(cap), jdet._prep_text(cap)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    ids = tdet._prep_text("the red chair . the sofa . the red table")[-1]
    if text_pad == 8:
        assert ids[-2:] == [vocab["."], vocab["[SEP]"]]


# ---------------------------------------------------------------------------
# Swin
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["tiny_40x56", "tiny_64", "swin_t_stage"])
def test_swin_matches_jax(case):
    """Sizes that are no multiple of the window exercise the padding and
    the shifted-window masks; the last case is SWIN_T's first stage
    (window 7, shift 3) at 25x23 patches, padded to 28x28."""
    if case == "swin_t_stage":
        kw = dict(embed_dim=96, depths=(2,), num_heads=(3,), window=7,
                  out_indices=(0,))
        jcfg, tcfg, hw = jswin.SwinConfig(**kw), tswin.SwinConfig(**kw), \
            (100, 92)
    else:
        jcfg, tcfg = jswin.SWIN_TINY_TEST, tswin.SWIN_TINY_TEST
        hw = (40, 56) if case == "tiny_40x56" else (64, 64)
    params = _rand_params(jswin.swin_param_shapes(jcfg), seed=3)
    model = interop.load_flat_params(tswin.SwinBackbone(tcfg, device="cpu"),
                                     _strip(params, "backbone.0."))
    x = np.random.default_rng(0).normal(0, 1, (1, 3) + hw).astype(np.float32)
    want = jax.jit(lambda p, v: jswin.swin_forward(p, jcfg, v))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    with torch.no_grad():
        got = model(_t(x))
    assert len(got) == len(want) == len(tcfg.out_indices)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4,
                                   rtol=1e-3)


def test_swin_index_and_shift_masks_equal_jax():
    for ws in (4, 7, 12):
        np.testing.assert_array_equal(tswin._rel_pos_index(ws),
                                      jswin._rel_pos_index(ws))
    # SWIN_T at 800: 200 -> 203, 100 -> 105, 50 -> 56, 25 -> 28
    for hp in (203, 105, 56, 28, 8):
        ws = 4 if hp == 8 else 7
        np.testing.assert_array_equal(
            tswin._shift_attn_mask(hp, hp, ws, ws // 2),
            jswin._shift_attn_mask(hp, hp, ws, ws // 2))


# ---------------------------------------------------------------------------
# deformable attention
# ---------------------------------------------------------------------------

def _grid_sample_core(value, shapes, loc, aw):
    """The independent oracle: per level F.grid_sample + weighted sum
    (tests/test_deform_attn.py)."""
    b, _, nh, d = value.shape
    q, p = loc.shape[1], loc.shape[4]
    out = np.zeros((b, q, nh, d), np.float32)
    start = 0
    for lvl, (hh, ww) in enumerate(shapes):
        v = value[:, start:start + hh * ww]
        start += hh * ww
        v = torch.from_numpy(
            v.transpose(0, 2, 3, 1).reshape(b * nh, d, hh, ww).copy())
        g = torch.from_numpy(
            (2 * loc[:, :, :, lvl] - 1).transpose(0, 2, 1, 3, 4)
            .reshape(b * nh, q, p, 2).copy())
        s = F.grid_sample(v, g, mode="bilinear", padding_mode="zeros",
                          align_corners=False).numpy()  # (b*nh, d, q, p)
        w_ = aw[:, :, :, lvl].transpose(0, 2, 1, 3).reshape(b * nh, 1, q, p)
        out += (s * w_).sum(-1).reshape(b, nh, d, q).transpose(0, 3, 1, 2)
    return out.reshape(b, q, nh * d)


def test_ms_deform_attn_core_matches_jax_and_grid_sample():
    rng = np.random.default_rng(0)
    shapes = ((8, 12), (4, 6), (2, 3))
    nv = sum(h * w for h, w in shapes)
    b, q, nh, d, p = 2, 7, 4, 8, 3
    value = rng.normal(size=(b, nv, nh, d)).astype(np.float32)
    # locations straddling the borders and outside [0,1]: zero padding
    loc = rng.uniform(-0.2, 1.2,
                      (b, q, nh, len(shapes), p, 2)).astype(np.float32)
    aw = rng.uniform(0, 1, (b, q, nh, len(shapes), p)).astype(np.float32)
    aw /= aw.reshape(b, q, nh, -1).sum(-1).reshape(b, q, nh, 1, 1)
    got = tda.ms_deform_attn_core(_t(value), shapes, _t(loc), _t(aw))
    want = jda.ms_deform_attn_core(jnp.asarray(value), shapes,
                                   jnp.asarray(loc), jnp.asarray(aw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    np.testing.assert_allclose(got.numpy(),
                               _grid_sample_core(value, shapes, loc, aw),
                               atol=2e-5)
    v4 = rng.normal(size=(3, 5, 6, 4)).astype(np.float32)
    l4 = rng.uniform(-0.3, 1.3, (3, 9, 2, 2)).astype(np.float32)
    np.testing.assert_allclose(
        tda.bilinear_sample(_t(v4), _t(l4)).numpy(),
        np.asarray(jda.bilinear_sample(jnp.asarray(v4), jnp.asarray(l4))),
        atol=2e-5)


@pytest.mark.parametrize("ref_dim", [2, 4])
def test_deform_attn_module_matches_jax(ref_dim):
    """The full module with the reference init (its compass-rose offsets
    and zero attention logits), offsets perturbed so they matter, a key
    padding mask, centres or boxes as reference points."""
    jp = jda.init_deform_attn(jax.random.PRNGKey(1), 32, 4, 3, 2)
    rng = np.random.default_rng(2)
    jp = {m: {k: np.asarray(v) + (rng.normal(0, 0.05, np.shape(v))
                                  .astype(np.float32) if k == "w" else 0)
              for k, v in d.items()} for m, d in jp.items()}
    shapes = ((6, 8), (3, 4), (2, 2))
    nv = sum(h * w for h, w in shapes)
    qry = rng.normal(size=(2, 5, 32)).astype(np.float32)
    val = rng.normal(size=(2, nv, 32)).astype(np.float32)
    ref = rng.uniform(0.1, 0.9, (2, 5, 3, ref_dim)).astype(np.float32)
    pos = rng.normal(size=(2, 5, 32)).astype(np.float32)
    kpm = rng.uniform(size=(2, nv)) < 0.2
    want = jda.deform_attn(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(qry), jnp.asarray(val),
        jnp.asarray(ref), shapes, n_heads=4, n_points=2,
        query_pos=jnp.asarray(pos), key_padding_mask=jnp.asarray(kpm))
    got = tda.deform_attn(
        {m: {k: _t(v) for k, v in d.items()} for m, d in jp.items()},
        _t(qry), _t(val), _t(ref), shapes, n_heads=4, n_points=2,
        query_pos=_t(pos), key_padding_mask=_t(kpm))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-4)
    # the port's own init: the same compass rose and zero logits
    tp = tda.init_deform_attn(torch.Generator().manual_seed(0), 32, 4, 3, 2)
    raw = jda.init_deform_attn(jax.random.PRNGKey(0), 32, 4, 3, 2)
    np.testing.assert_array_equal(tp["sampling_offsets"]["b"].numpy(),
                                  np.asarray(raw["sampling_offsets"]["b"]))
    assert not tp["attention_weights"]["w"].any()


# ---------------------------------------------------------------------------
# the whole detector
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_pair():
    jcfg, tcfg = jg.GDINO_TINY_TEST, tg.GDINO_TINY_TEST
    params = _rand_params(jg.grounding_param_shapes(jcfg), seed=0)
    model = interop.grounding_from_numpy(params, tcfg, device="cpu")
    vocab = jbert.make_test_vocab(WORDS)
    return (jg.GroundingDINOJax(params, jcfg, jbert.BertTokenizer(vocab)),
            tg.GroundingDINOTorch(model, tbert.BertTokenizer(vocab)))


def test_grounding_forward_matches_jax(tiny_pair):
    jdet, tdet = tiny_pair
    cfg = tdet.cfg
    rng = np.random.default_rng(4)
    image = rng.normal(0, 1, (1, 3, cfg.img_size, cfg.img_size)
                       ).astype(np.float32)
    ids_np, attn, pos, pad, _ = tdet._prep_text("the red chair . a sofa")
    want = jdet._fwd(jdet.params, image=jnp.asarray(image),
                     input_ids=jnp.asarray(ids_np),
                     text_attn_3d=jnp.asarray(attn),
                     position_ids=jnp.asarray(pos),
                     text_pad_mask=jnp.asarray(pad))
    args = [_t(a) for a in (image, ids_np, attn, pos, pad)]
    with torch.no_grad():
        enc = tdet.model.encode(*args)
        sel = tdet.model.select(enc)
        got = tdet.model.decode(enc, sel)
    # torch.topk(sorted=True) orders the selection as jax.lax.top_k does
    # on the same scores (the decoder's query embeddings are per slot, so
    # the order matters, not just the set)
    _, jidx = jax.lax.top_k(jnp.asarray(sel["score"].numpy()),
                            cfg.num_queries)
    np.testing.assert_array_equal(sel["topk_idx"].numpy(), np.asarray(jidx))
    wl, gl = np.asarray(want["pred_logits"]), got["pred_logits"].numpy()
    np.testing.assert_array_equal(np.isneginf(gl), np.isneginf(wl))
    assert np.isneginf(gl[..., ids_np.shape[1]:]).all()
    fin = np.isfinite(wl)
    np.testing.assert_allclose(gl[fin], wl[fin], atol=2e-3, rtol=1e-2)
    np.testing.assert_allclose(got["pred_boxes"].numpy(),
                               np.asarray(want["pred_boxes"]), atol=2e-3,
                               rtol=1e-2)
    with torch.no_grad():
        again = tdet.model(*args)
    assert torch.equal(again["pred_boxes"], got["pred_boxes"])


@pytest.mark.parametrize("h_w", [(48, 64), (80, 72)])
def test_predict_equal_jax(tiny_pair, h_w):
    """Kept boxes, scores and phrases at a threshold between two scores:
    the image is resized to the square input (up, or down with the
    antialias) as jax.image.resize does."""
    jdet, tdet = tiny_pair
    img = np.random.default_rng(0).uniform(0, 1, h_w + (3,)) \
        .astype(np.float32)
    jb, js, jp = jdet.predict(img, CAPTION, box_threshold=0.0)
    tb, ts, tp = tdet.predict(img, CAPTION, box_threshold=0.0)
    np.testing.assert_allclose(tb, jb, atol=2e-3, rtol=1e-2)
    np.testing.assert_allclose(ts, js, atol=2e-3, rtol=1e-2)
    assert tp == jp
    s = np.sort(js)[::-1]
    thr = float(s[len(s) // 3] + s[len(s) // 3 + 1]) / 2
    jb, js, jp = jdet.predict(img, CAPTION, box_threshold=thr)
    tb, ts, tp = tdet.predict(img, CAPTION, box_threshold=thr)
    assert len(tb) == len(jb) == len(s) // 3 + 1
    np.testing.assert_allclose(tb, jb, atol=2e-3, rtol=1e-2)
    assert tp == jp


def test_param_shapes_match_jax_and_the_checkpoint_manifest():
    """The official groundingdino_swint_ogc.pth's names and shapes
    (tests/golden) minus what the model rebuilds are exactly
    GroundingDINO's state_dict at GDINO_SWINT (meta device: nothing
    allocated), and the port's shape tables equal goi_tpu's."""
    full = tg.grounding_param_shapes(tg.GDINO_SWINT)
    assert full == jg.grounding_param_shapes(jg.GDINO_SWINT)
    tiny = tg.grounding_param_shapes(tg.GDINO_TINY_TEST)
    assert tiny == jg.grounding_param_shapes(jg.GDINO_TINY_TEST)
    assert tbert.bert_param_shapes(tbert.BERT_BASE) == \
        jbert.bert_param_shapes(jbert.BERT_BASE)
    assert tswin.swin_param_shapes(tswin.SWIN_B) == \
        jswin.swin_param_shapes(jswin.SWIN_B)
    with open(MANIFEST) as f:
        manifest = {k: tuple(v) for k, v in json.load(f).items()}
    assert {k: v for k, v in manifest.items()
            if not tg._is_rebuilt(k)} == full
    model = tg.GroundingDINO(tg.GDINO_SWINT, device="meta")
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == full
    assert 170e6 < sum(v.numel() for v in model.parameters()) < 175e6


def test_load_groundingdino_params_loads_strict(tmp_path):
    """A checkpoint in the released layout ("module." prefix, the Swin
    index buffers, BERT's position ids, the decoder's bbox_embed aliases)
    loads into the model with strict=True."""
    cfg = tg.GDINO_TINY_TEST
    params = _rand_params(tg.grounding_param_shapes(cfg), seed=7)
    sd = {"module." + k: torch.as_tensor(v) for k, v in params.items()}
    sd["module.backbone.0.layers.0.blocks.0.attn.relative_position_index"] = \
        torch.zeros(16, 16, dtype=torch.long)
    sd["module.bert.embeddings.position_ids"] = torch.arange(64)[None]
    sd["module.transformer.decoder.bbox_embed.0.layers.0.weight"] = \
        sd["module.bbox_embed.0.layers.0.weight"]
    path = tmp_path / "gdino.pth"
    torch.save({"model": sd}, path)
    loaded = tg.load_groundingdino_params(str(path))
    assert loaded.keys() == params.keys()
    model = interop.grounding_from_numpy(loaded, cfg, device="cpu")
    np.testing.assert_array_equal(
        model.state_dict()["transformer.level_embed"].numpy(),
        params["transformer.level_embed"])


def test_init_follows_the_jax_rules():
    cfg = dataclasses.replace(tg.GDINO_TINY_TEST, enc_layers=1, dec_layers=1)
    m = tg.init_grounding_(tg.GroundingDINO(cfg, device="cpu"),
                           torch.Generator().manual_seed(0))
    sd = m.state_dict()
    fl = "transformer.encoder.fusion_layers.0"
    assert torch.equal(sd[f"{fl}.gamma_v"], torch.full((32,), 1e-4))
    assert torch.equal(sd["transformer.decoder.norm.weight"],
                       torch.ones(32))
    assert torch.equal(sd["feat_map.bias"], torch.zeros(32))
    w = sd["transformer.encoder.layers.0.linear1.weight"]
    assert abs(float(w.std()) * 32 ** 0.5 - 1) < 0.1
