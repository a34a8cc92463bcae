"""The port's GroundingDINO and SAM against the benchmark's plain
reference (portbench/reference/towers.py: the published equations in
plain torch, F.grid_sample for the deformable sampling) at tiny widths
on the CPU, on a square and a non-square view; the published input
rule's (h, w); and the RES request's spans and counters armed under a
profiler. Both sides load the same state_dict (the official
checkpoints' key names)."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from goi_tpu_torch.query import grounding as tg
from goi_tpu_torch.query import sam as tsam
from goi_tpu_torch.query._nn import init_by_rule_
from goi_tpu_torch.query.bert import BertTokenizer, make_test_vocab
from goi_tpu_torch.query.res import TorchRESProvider
from goi_tpu_torch.utils import profiling
from portbench.reference import towers as ref

torch.set_num_threads(1)

WORDS = ("the", "red", "chair", "a", "blue", "sofa", "near", "lamp")
PROMPT = "the red chair near a lamp"
# one windowed block (grid 8 at window 3 pads to 9) and one global block
SAM_TINY = tsam.SAMConfig(embed_dim=32, depth=2, num_heads=2,
                          global_attn=(1,), window=3, img_size=64, patch=8,
                          prompt_dim=16, mask_in_chans=4, decoder_heads=2,
                          decoder_mlp=32)
# float32 on both sides; the reference resizes with F.interpolate's
# antialiased filter (the port's resize_linear agrees to ~1e-5), sums
# GEMMs in another order and samples through F.grid_sample
TOL = 2e-5


def dino_dict(cfg: tg.GroundingConfig) -> dict:
    """The reference's configuration (the published names) of a port
    configuration."""
    s, b = cfg.swin, cfg.bert
    return {"hidden_dim": cfg.d_model, "nheads": cfg.heads,
            "enc_layers": cfg.enc_layers, "dec_layers": cfg.dec_layers,
            "dim_feedforward": cfg.ffn, "enc_n_points": cfg.n_points,
            "dec_n_points": cfg.n_points, "num_queries": cfg.num_queries,
            "max_text_len": cfg.max_text_len, "text_pad": cfg.text_pad,
            "pe_temperatureH": cfg.pe_temperature,
            "input": {"size": cfg.img_size, "max_size": cfg.max_size},
            "swin": {"embed_dim": s.embed_dim, "depths": list(s.depths),
                     "num_heads": list(s.num_heads),
                     "window_size": s.window,
                     "out_indices": list(s.out_indices)},
            "bert": {"num_attention_heads": b.heads,
                     "num_hidden_layers": b.layers,
                     "layer_norm_eps": 1e-12}}


def sam_dict(cfg: tsam.SAMConfig) -> dict:
    return {"encoder_embed_dim": cfg.embed_dim,
            "encoder_depth": cfg.depth, "encoder_num_heads": cfg.num_heads,
            "encoder_global_attn_indexes": list(cfg.global_attn),
            "window_size": cfg.window, "image_size": cfg.img_size,
            "vit_patch_size": cfg.patch, "decoder_heads": cfg.decoder_heads,
            "decoder_depth": cfg.decoder_depth,
            "num_multimask_outputs": cfg.num_multimask}


def _rule(name, shape, g):
    """Norms near one, biases and layer scales small, matrices at their
    fan-in scale: every term of every layer carries weight."""
    r = torch.randn(shape, generator=g)
    if ("norm" in name.lower() or "gamma" in name) and len(shape) == 1:
        return 1.0 + 0.2 * r if "gamma" not in name else 0.3 * r
    if len(shape) == 1:
        return 0.05 * r
    fan = shape[-1] if len(shape) == 2 else int(np.prod(shape[1:]))
    return r / np.sqrt(fan)


@pytest.fixture(scope="module")
def towers():
    g = torch.Generator().manual_seed(3)
    dino = init_by_rule_(tg.GroundingDINO(tg.GDINO_TINY_TEST, device="cpu"),
                         g, _rule).eval()
    # contrastive logits of unit scale, as the cell's towers have them,
    # so that the scores spread below a saturated sigmoid
    with torch.no_grad():
        dino.transformer.decoder.norm.weight.mul_(1 / 16)
        dino.transformer.decoder.norm.bias.mul_(1 / 16)
    sam = init_by_rule_(tsam.SAM(SAM_TINY, device="cpu"), g, _rule).eval()
    vocab = make_test_vocab(WORDS)
    return (tg.GroundingDINOTorch(dino, BertTokenizer(vocab)),
            tsam.SamTorch(sam), vocab)


def _view(h, w, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (h, w, 3)) \
        .astype(np.float32)


def _gap(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("hw", [(64, 64), (48, 80)], ids=["square",
                                                          "wide"])
def test_grounding_matches_the_reference(towers, hw):
    det, _, vocab = towers
    view = _view(*hw)
    args, _ = det.inputs(view, PROMPT)
    with torch.no_grad():
        enc = det.model.encode(*args)
        sel = det.model.select(enc)
        got = det.model.decode(enc, sel)
        dcfg = dino_dict(det.cfg)
        image = ref.dino_image(view, dcfg, "cpu")
        assert image.shape == args[0].shape
        assert _gap(args[0], image) < TOL
        tok = ref.caption_tokens(PROMPT, vocab, det.cfg.text_pad)
        np.testing.assert_array_equal(args[1][0].numpy(), tok["ids"])
        np.testing.assert_array_equal(args[2][0].numpy(), tok["attn"])
        np.testing.assert_array_equal(args[3][0].numpy(), tok["pos"])
        np.testing.assert_array_equal(~args[4][0].numpy(), tok["real"])
        want = ref.gdino(det.model.state_dict(), dcfg, image, tok,
                         select=sel["topk_idx"])
    assert list(enc["shapes"]) == want["shapes"]
    assert _gap(sel["score"], want["score"]) < TOL
    # the port's selection is the reference's top-k up to near-equal
    # scores trading places
    top = want["score"].topk(det.cfg.num_queries).values
    assert _gap(want["score"].gather(1, sel["topk_idx"]), top) < TOL
    wl, gl = want["pred_logits"], got["pred_logits"]
    fin = torch.isfinite(wl)
    assert torch.equal(fin, torch.isfinite(gl))
    assert _gap(gl[fin], wl[fin]) < TOL
    assert float((got["pred_boxes"] - want["pred_boxes"]).abs().max()) < TOL


@pytest.mark.parametrize("hw", [(64, 64), (48, 80)], ids=["square",
                                                          "wide"])
def test_sam_matches_the_reference(towers, hw):
    _, sam, _ = towers
    view = _view(*hw, seed=1)
    h, w = hw
    boxes = np.array([[2, 3, w * 0.6, h * 0.7], [w * 0.3, h * 0.2, w - 2,
                                                  h - 1]], np.float32)
    sam.set_image(view)
    masks, _ = sam.predict_boxes(boxes)
    scfg = sam_dict(SAM_TINY)
    sd = sam.model.state_dict()
    with torch.no_grad():
        x, in_hw = ref.sam_image(view, scfg, "cpu")
        assert in_hw == sam._new_hw
        emb = ref.sam_encoder(sd, scfg, x)
        logits = ref.sam_decode(sd, scfg, emb, torch.as_tensor(boxes),
                                in_hw, hw)
        no_rel = ref.sam_encoder(sd, scfg, x, rel_pos=False)
    assert _gap(sam._emb, emb) < TOL
    # the relative positions are in play: leaving them out moves the
    # embedding far past the tolerance
    assert _gap(no_rel, emb) > 100 * TOL
    sure = logits.abs() > 1e-3 * logits.abs().max()
    assert masks.shape == (2, 1) + hw
    np.testing.assert_array_equal(masks[sure.numpy()],
                                  (logits > 0)[sure].numpy())


@pytest.mark.parametrize("hw, want", [
    ((968, 1296), (800, 1071)),       # ScanNet's colour frame
    ((840, 1297), (800, 1235)),       # MipNeRF360 garden at images_4
    ((1200, 700), (1333, 778)),       # a tall view: the long side clips
    ((800, 2000), (533, 1332)),       # a panorama clipped at 1333
    ((800, 1000), (800, 1000)),       # already at the short side
])
def test_published_input_shape(hw, want):
    assert tg.input_hw(*hw, 800, 1333) == want
    assert ref.dino_size(*hw, 800, 1333) == want
    det = object.__new__(tg.GroundingDINOTorch)
    det.cfg = tg.GDINO_SWINT
    assert det.input_hw(*hw) == want


def test_square_views_enter_square():
    """On a square view the published rule gives the old square input,
    so the goi_tpu parity tests' square images feed both packages the
    same tensor."""
    for s in (64, 800, 1024):
        assert tg.input_hw(s, s, tg.GDINO_SWINT.img_size,
                           tg.GDINO_SWINT.max_size) == (800, 800)
    assert tg.input_hw(48, 48, 64, 1333) == (64, 64)


def test_res_request_spans_and_counters(towers):
    det, sam, _ = towers
    view = _view(48, 80, seed=2)
    _, scores, _ = det.predict(view, PROMPT, box_threshold=0.0)
    s = np.sort(scores)[::-1]
    prov = TorchRESProvider(det, sam,
                            box_threshold=float(s[2] + s[3]) / 2)
    reached, shapes = [], []
    predict_boxes, encode = sam.predict_boxes, det.model.encode

    def boxes_in(boxes, multimask=False):
        reached.append(len(boxes))
        return predict_boxes(boxes, multimask)

    def encode_(*a):
        out = encode(*a)
        shapes.append(out["shapes"])
        return out

    sam.predict_boxes, det.model.encode = boxes_in, encode_
    profiling.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            # a caller's request unit around the render and the mask:
            # predict_mask's own unit joins it
            with profiling.span("res.request"):
                mask = prov.predict_mask(view, PROMPT)
            mask2 = prov.predict_mask(view, PROMPT)
        snap = profiling.snapshot()
    finally:
        del sam.predict_boxes, det.model.encode
        profiling.reset()
    assert mask is not None and np.array_equal(mask, mask2)
    assert reached == [3, 3] and len(shapes) == 2
    assert snap["units"] == {"res.request": 2}
    assert snap["counters"]["res.boxes"] == 6
    tokens = sum(h * w for h, w in shapes[0])
    assert snap["counters"]["dino.image_tokens"] == 2 * tokens
    cfg = det.cfg
    per_query = cfg.heads * cfg.levels * cfg.n_points
    assert snap["counters"]["deform.samples"] == 2 * per_query * (
        cfg.enc_layers * tokens + cfg.dec_layers * cfg.num_queries)
    spans = snap["spans"]
    for name in ("dino.backbone", "dino.text", "dino.encoder",
                 "dino.decoder", "sam.encoder", "sam.decode", "res.host"):
        assert spans[name]["calls"] >= 2, name
    assert spans["deform_attn"]["calls"] == 2 * (cfg.enc_layers
                                                 + cfg.dec_layers)
    assert spans["res.request"]["calls"] == 2
    # disarmed, nothing records
    prov.predict_mask(view, PROMPT)
    assert profiling.snapshot()["units"] == {}

