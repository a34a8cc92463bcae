"""Floating-point operations of the viewer's RES request, from the towers'
published widths and the view's size, frozen with the benchmark.

They count what the math needs, as counts.py does: every product of a
linear layer, a convolution and an attention (2 m n k), the windowed
layers over the image's own tokens, each attending to the ws x ws keys
of its window as the published code runs them (the rows of the zero
padding that fills the last windows are work, not math, and are left
out), and
deformable attention's bilinear samples (10 operations a sample and a
channel: four weighted corners and the attention weight's multiply-add).
Norms, softmaxes, activations, resizes and the render are left out
(under a percent of the request's count together).
"""

from __future__ import annotations

import math

from portbench.reference.towers import dino_size


def _mm(m, n, k) -> float:
    return 2.0 * m * n * k


def swin(cfg: dict, h: int, w: int) -> tuple:
    """(operations, [(C, h, w) of the out_indices' maps]) of Swin on an
    h x w input."""
    e, ws = cfg["embed_dim"], cfg["window_size"]
    h, w = math.ceil(h / 4), math.ceil(w / 4)
    ops = _mm(h * w, e, 3 * 16)
    maps = []
    for i, depth in enumerate(cfg["depths"]):
        c = e * 2 ** i
        tok = h * w
        n = ws * ws
        per = (_mm(tok, 3 * c, c) + _mm(tok, c, c)
               + 2 * _mm(tok, n, c)                 # QK and AV a window
               + 2 * _mm(tok, int(c * cfg["mlp_ratio"]), c))
        ops += depth * per
        if i in cfg["out_indices"]:
            maps.append((c, h, w))
        if i < len(cfg["depths"]) - 1:
            h, w = (h + 1) // 2, (w + 1) // 2
            ops += _mm(h * w, 2 * c, 4 * c)
    return ops, maps


def bert(cfg: dict, n: int) -> float:
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    per = 4 * _mm(n, d, d) + 2 * _mm(n, n, d) + 2 * _mm(n, f, d)
    return cfg["num_hidden_layers"] * per


def _msda(q, s, d, heads, levels, points) -> float:
    samples = q * heads * levels * points
    return (_mm(s, d, d) + _mm(q, 2 * heads * levels * points, d)
            + _mm(q, heads * levels * points, d) + _mm(q, d, d)
            + 10.0 * samples * (d // heads))


def _mha(q, k, d) -> float:
    return _mm(q, d, d) + 2 * _mm(k, d, d) + 2 * _mm(q, k, d) + _mm(q, d, d)


def gdino(cfg: dict, h: int, w: int) -> dict:
    """Operations of GroundingDINO on an h x w view: {backbone, text,
    encoder, decoder, tokens}."""
    d, f, heads = cfg["hidden_dim"], cfg["dim_feedforward"], cfg["nheads"]
    nl, npt = cfg["num_feature_levels"], cfg["enc_n_points"]
    L, nq = cfg["text_pad"], cfg["num_queries"]
    oh, ow = dino_size(h, w, cfg["input"]["size"], cfg["input"]["max_size"])
    ops, maps = swin(cfg["swin"], oh, ow)
    shapes = [(hh, ww) for _, hh, ww in maps]
    for c, hh, ww in maps:
        ops += _mm(hh * ww, d, c)
    c, hh, ww = maps[-1]
    hh, ww = (hh - 1) // 2 + 1, (ww - 1) // 2 + 1
    shapes.append((hh, ww))
    ops += _mm(hh * ww, d, 9 * c)
    s = sum(a * b for a, b in shapes)
    b = cfg["bert"]
    text = bert(b, L) + _mm(L, d, b["hidden_size"])
    inner = f // 2
    fusion = (2 * _mm(s, inner, d) + 2 * _mm(L, inner, d)
              + 3 * _mm(s, L, inner) + _mm(s, d, inner) + _mm(L, d, inner))
    text_layer = _mha(L, L, d) + 2 * _mm(L, f // 2, d)
    enc_layer = _msda(s, s, d, heads, nl, npt) + 2 * _mm(s, f, d)
    encoder = cfg["enc_layers"] * (fusion + text_layer + enc_layer)
    select = _mm(s, d, d) + _mm(s, L, d) + 2 * _mm(s, d, d) + _mm(s, 4, d)
    dec_layer = (_mha(nq, nq, d) + _mha(nq, L, d)
                 + _msda(nq, s, d, heads, nl, cfg["dec_n_points"])
                 + 2 * _mm(nq, f, d) + _mm(nq, d, 2 * d) + _mm(nq, d, d)
                 + 2 * _mm(nq, d, d) + _mm(nq, 4, d))
    heads_out = _mm(nq, L, d) + 2 * _mm(nq, d, d) + _mm(nq, 4, d)
    decoder = select + cfg["dec_layers"] * dec_layer + heads_out
    return {"backbone": ops, "text": text, "encoder": encoder,
            "decoder": decoder, "tokens": s, "input_hw": [oh, ow]}


def sam_encoder(cfg: dict) -> float:
    e, heads = cfg["encoder_embed_dim"], cfg["encoder_num_heads"]
    ps, ws = cfg["vit_patch_size"], cfg["window_size"]
    g = cfg["image_size"] // ps
    tok = g * g
    hd = e // heads
    ops = _mm(tok, e, 3 * ps * ps)
    for i in range(cfg["encoder_depth"]):
        n, side = (tok, g) if i in cfg["encoder_global_attn_indexes"] \
            else (ws * ws, ws)
        ops += (_mm(tok, 3 * e, e) + _mm(tok, e, e) + 2 * _mm(tok, n, e)
                + 2 * _mm(tok, side, hd) * heads    # decomposed rel-pos
                + 2 * _mm(tok, 4 * e, e))
    pd = cfg["prompt_embed_dim"]
    return ops + _mm(tok, pd, e) + _mm(tok, pd, 9 * pd)


def sam_decode_per_box(cfg: dict) -> float:
    """Operations of the prompt encoder and mask decoder for one box
    (the multimask tokens are computed, as published, then one kept)."""
    pd = cfg["prompt_embed_dim"]
    g = cfg["image_size"] // cfg["vit_patch_size"]
    keys, half, mlp = g * g, pd // 2, cfg["decoder_mlp_dim"]
    t = 1 + cfg["num_multimask_outputs"] + 1 + 2
    to_image = (_mm(t, half, pd) + 2 * _mm(keys, half, pd)
                + 2 * _mm(t, keys, half) + _mm(t, pd, half))
    to_token = (_mm(keys, half, pd) + 2 * _mm(t, half, pd)
                + 2 * _mm(keys, t, half) + _mm(keys, pd, half))
    layer = (4 * _mm(t, pd, pd) + 2 * _mm(t, t, pd) + to_image
             + 2 * _mm(t, mlp, pd) + to_token)
    ops = cfg["decoder_depth"] * layer + to_image
    up1, up2 = 4 * keys, 16 * keys
    ops += _mm(up1, pd // 4, pd) + _mm(up2, pd // 8, pd // 4)
    nm = cfg["num_multimask_outputs"] + 1
    ops += nm * (2 * _mm(1, pd, pd) + _mm(1, pd // 8, pd))
    return ops + _mm(nm, up2, pd // 8)


def request(config: dict, h: int, w: int) -> dict:
    """The request's operations on an h x w view: the part every request
    does (`fixed_flops`: GroundingDINO and SAM's image encoder) and the
    part a box that reaches SAM adds (`box_flops`), with GroundingDINO's
    parts and image tokens."""
    dino = gdino(config["gdino"], h, w)
    enc = sam_encoder(config["sam"])
    fixed = dino["backbone"] + dino["text"] + dino["encoder"] \
        + dino["decoder"] + enc
    return {"fixed_flops": fixed, "box_flops": sam_decode_per_box(
        config["sam"]), "sam_encoder_flops": enc, "gdino": dino}
