"""Plain reference of the viewer's RES request: GroundingDINO Swin-T OGC
(https://github.com/IDEA-Research/GroundingDINO, groundingdino/config/
GroundingDINO_SwinT_OGC.py) and SAM ViT-H (https://github.com/
facebookresearch/segment-anything, segment_anything/build_sam.py
build_sam_vit_h), from a rendered view and a prompt to the union mask.

Plain torch in float32, written from the two codebases' equations as
functions of a state_dict under the official checkpoints' key names:
Swin-T (backbone/swin_transformer.py), BERT-base (HF BertModel, through
bertwarper.py's sub-sentence masks), the input projections, the
feature enhancer (fuse_modules.py BiAttentionBlock, transformer_vanilla
.py's text layer, the deformable encoder layer), the language-guided
query selection, the decoder with iterative box refinement and the
contrastive heads (transformer.py, groundingdino.py, utils.py), then
SAM's ViT image encoder with windowed and global attention and
decomposed relative positions (modeling/image_encoder.py), its prompt
encoder (prompt_encoder.py) and two-way mask decoder (transformer.py,
mask_decoder.py), with SamPredictor's pre- and post-processing
(predictor.py, modeling/sam.py). Deformable attention samples with
F.grid_sample, as GroundingDINO's multi_scale_deformable_attn_pytorch
does. The caller sets allow_tf32 False for matmul and cuDNN.

Departures from the published code:
- the vocabulary is synthetic: every word of a caption is one WordPiece
  of a small vocabulary (no "##" continuation is needed), over the
  published 30,522-row word-embedding table; no BPE is used, since the
  CLIP re-ranker is not (last item);
- the caption is padded to `text_pad` (64) tokens whose pad rows attend
  only themselves at position 0 (the published tokenizer pads to the
  longest caption, which for one caption is none); every mask keeps the
  real tokens from the pads, so their outputs are the published ones;
- both models resize the float [0, 1] view with an antialiased bilinear
  filter (F.interpolate, antialias=True) rather than PIL's on a uint8
  image, and SAM normalises that float view with its 0-255 pixel mean
  and std, as the request hands it over;
- the re-rank's first stage uses the detector's scores in place of GOI's
  CLIP ViT-B/32 phrase-to-prompt similarity (ref:guidance/res_model.py
  :381-401), as the program does with no text similarity configured.
"""

from __future__ import annotations

import math
import re

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
SAM_PIXEL_MEAN = (123.675, 116.28, 103.53)
SAM_PIXEL_STD = (58.395, 57.12, 57.375)


def _lin(sd, name, x):
    return F.linear(x, sd[name + ".weight"], sd.get(name + ".bias"))


def _ln(sd, name, x, eps):
    return F.layer_norm(x, x.shape[-1:], sd[name + ".weight"],
                        sd[name + ".bias"], eps)


def _mlp(sd, name, x, n):
    for i in range(n):
        x = _lin(sd, f"{name}.layers.{i}", x)
        if i < n - 1:
            x = F.relu(x)
    return x


# ---------------------------------------------------------------------------
# GroundingDINO: inputs
# ---------------------------------------------------------------------------

def dino_size(h: int, w: int, size: int, max_size: int) -> tuple:
    """(oh, ow) of RandomResize([size], max_size)
    (datasets/transforms.py get_size_with_aspect_ratio)."""
    min_s, max_s = float(min(w, h)), float(max(w, h))
    if max_s / min_s * size > max_size:
        size = int(round(max_size * min_s / max_s))
    if (w <= h and w == size) or (h <= w and h == size):
        return h, w
    if w < h:
        return int(size * h / w), size
    return size, int(size * w / h)


def _resize(img_hwc: torch.Tensor, hw) -> torch.Tensor:
    x = img_hwc.permute(2, 0, 1)[None]
    if tuple(x.shape[2:]) == tuple(hw):
        return x
    return F.interpolate(x, size=tuple(hw), mode="bilinear",
                         align_corners=False, antialias=True)


def dino_image(image: np.ndarray, cfg: dict, device) -> torch.Tensor:
    """(1, 3, oh, ow) ImageNet-normalised input of a float [0, 1] view."""
    x = torch.as_tensor(np.asarray(image, np.float32), device=device)
    x = _resize(x, dino_size(x.shape[0], x.shape[1], cfg["input"]["size"],
                             cfg["input"]["max_size"]))
    mean = torch.tensor(IMAGENET_MEAN, device=device)[None, :, None, None]
    std = torch.tensor(IMAGENET_STD, device=device)[None, :, None, None]
    return (x - mean) / std


def caption_tokens(caption: str, vocab: dict, text_pad: int) -> dict:
    """The caption's ids ([CLS] words . [SEP], padded), the bertwarper
    sub-sentence attention and position ids
    (generate_masks_with_special_tokens_and_transfer_map) and the token
    mask (True = a real token)."""
    cap = caption.lower().strip()
    if not cap.endswith("."):
        cap = cap + "."
    words = re.findall(r"[a-z0-9]+|[^\sa-z0-9]", cap)
    ids = [vocab["[CLS]"]] + [vocab[w] for w in words] + [vocab["[SEP]"]]
    n = len(ids)
    if n > text_pad:
        raise ValueError(f"{n} tokens over text_pad {text_pad}")
    special = {vocab[t] for t in ("[CLS]", "[SEP]", ".", "?") if t in vocab}
    attn = np.eye(text_pad, dtype=bool)
    pos = np.zeros(text_pad, np.int64)
    prev = 0
    for col in [j for j, t in enumerate(ids) if t in special]:
        if col not in (0, n - 1):
            attn[prev + 1:col + 1, prev + 1:col + 1] = True
            pos[prev + 1:col + 1] = np.arange(col - prev)
        prev = col
    out = np.full(text_pad, vocab.get("[PAD]", 0), np.int64)
    out[:n] = ids
    real = np.zeros(text_pad, bool)
    real[:n] = True
    return {"ids": out, "attn": attn, "pos": pos, "real": real, "n": n}


# ---------------------------------------------------------------------------
# Swin-T (backbone/swin_transformer.py)
# ---------------------------------------------------------------------------

def _rel_index(ws: int, device) -> torch.Tensor:
    coords = torch.stack(torch.meshgrid(torch.arange(ws), torch.arange(ws),
                                        indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0).clone()
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1).reshape(-1).to(device)


def _windows(x, ws):
    b, h, w, c = x.shape
    x = x.view(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def _unwindows(win, ws, h, w):
    b = win.shape[0] // (h * w // ws // ws)
    x = win.view(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def _shift_mask(hp, wp, ws, shift, device):
    img = torch.zeros((1, hp, wp, 1), device=device)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for vs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, vs, :] = cnt
            cnt += 1
    mw = _windows(img, ws).squeeze(-1)
    m = mw[:, None, :] - mw[:, :, None]
    return m.masked_fill(m != 0, -100.0).masked_fill(m == 0, 0.0)


def _swin_block(sd, p, x, h, w, heads, ws, shift, mask, index):
    b, _, c = x.shape
    short = x
    x = _ln(sd, p + ".norm1", x, 1e-5).view(b, h, w, c)
    pr, pb = (ws - w % ws) % ws, (ws - h % ws) % ws
    x = F.pad(x, (0, 0, 0, pr, 0, pb))
    hp, wp = x.shape[1], x.shape[2]
    if shift:
        x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
    win = _windows(x, ws)
    bn, n, _ = win.shape
    qkv = _lin(sd, p + ".attn.qkv", win).reshape(bn, n, 3, heads, c // heads)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    attn = (q * (c // heads) ** -0.5) @ k.transpose(-2, -1)
    table = sd[p + ".attn.relative_position_bias_table"]
    attn = attn + table[index].view(n, n, -1).permute(2, 0, 1)[None]
    if shift:
        nw = mask.shape[0]
        attn = attn.view(bn // nw, nw, heads, n, n) + mask[None, :, None]
        attn = attn.view(-1, heads, n, n)
    out = (attn.softmax(-1) @ v).transpose(1, 2).reshape(bn, n, c)
    x = _unwindows(_lin(sd, p + ".attn.proj", out), ws, hp, wp)
    if shift:
        x = torch.roll(x, shifts=(shift, shift), dims=(1, 2))
    x = short + x[:, :h, :w].reshape(b, h * w, c)
    y = _ln(sd, p + ".norm2", x, 1e-5)
    y = _lin(sd, p + ".mlp.fc2", F.gelu(_lin(sd, p + ".mlp.fc1", y)))
    return x + y


def swin(sd: dict, cfg: dict, x: torch.Tensor) -> list:
    """(1, 3, H, W) -> the feature maps of out_indices."""
    pre = "backbone.0."
    ws, e = cfg["window_size"], cfg["embed_dim"]
    hh, ww = x.shape[2:]
    x = F.pad(x, (0, (4 - ww % 4) % 4, 0, (4 - hh % 4) % 4))
    x = F.conv2d(x, sd[pre + "patch_embed.proj.weight"],
                 sd[pre + "patch_embed.proj.bias"], stride=4)
    h, w = x.shape[2:]
    x = _ln(sd, pre + "patch_embed.norm", x.flatten(2).transpose(1, 2), 1e-5)
    index = _rel_index(ws, x.device)
    outs = []
    for i, depth in enumerate(cfg["depths"]):
        c = e * 2 ** i
        hp, wp = math.ceil(h / ws) * ws, math.ceil(w / ws) * ws
        mask = _shift_mask(hp, wp, ws, ws // 2, x.device)
        for j in range(depth):
            x = _swin_block(sd, f"{pre}layers.{i}.blocks.{j}", x, h, w,
                            cfg["num_heads"][i], ws,
                            0 if j % 2 == 0 else ws // 2, mask, index)
        if i in cfg["out_indices"]:
            y = _ln(sd, f"{pre}norm{i}", x, 1e-5)
            outs.append(y.view(-1, h, w, c).permute(0, 3, 1, 2))
        if i < len(cfg["depths"]) - 1:
            p = f"{pre}layers.{i}.downsample"
            y = x.view(-1, h, w, c)
            y = F.pad(y, (0, 0, 0, w % 2, 0, h % 2))
            y = torch.cat([y[:, 0::2, 0::2], y[:, 1::2, 0::2],
                           y[:, 0::2, 1::2], y[:, 1::2, 1::2]], -1)
            y = _ln(sd, p + ".norm", y.view(y.shape[0], -1, 4 * c), 1e-5)
            x = F.linear(y, sd[p + ".reduction.weight"])
            h, w = (h + 1) // 2, (w + 1) // 2
    return outs


# ---------------------------------------------------------------------------
# BERT-base (HF BertModel under bertwarper)
# ---------------------------------------------------------------------------

def bert(sd: dict, cfg: dict, ids, attn, pos) -> torch.Tensor:
    """(1, L) ids, (1, L, L) attention (True = attend), (1, L) position
    ids -> last_hidden_state (1, L, hidden)."""
    p = "bert."
    eps = cfg["layer_norm_eps"]
    x = (F.embedding(ids, sd[p + "embeddings.word_embeddings.weight"])
         + F.embedding(pos, sd[p + "embeddings.position_embeddings.weight"])
         + sd[p + "embeddings.token_type_embeddings.weight"][0])
    x = _ln(sd, p + "embeddings.LayerNorm", x, eps)
    ext = (1.0 - attn[:, None].float()) * torch.finfo(torch.float32).min
    nh = cfg["num_attention_heads"]
    b, n, d = x.shape
    for i in range(cfg["num_hidden_layers"]):
        q_ = f"{p}encoder.layer.{i}."

        def heads(t):
            return t.view(b, n, nh, d // nh).transpose(1, 2)

        q = heads(_lin(sd, q_ + "attention.self.query", x))
        k = heads(_lin(sd, q_ + "attention.self.key", x))
        v = heads(_lin(sd, q_ + "attention.self.value", x))
        s = q @ k.transpose(-1, -2) / math.sqrt(d // nh) + ext
        o = (s.softmax(-1) @ v).transpose(1, 2).reshape(b, n, d)
        x = _ln(sd, q_ + "attention.output.LayerNorm",
                _lin(sd, q_ + "attention.output.dense", o) + x, eps)
        y = F.gelu(_lin(sd, q_ + "intermediate.dense", x))
        x = _ln(sd, q_ + "output.LayerNorm",
                _lin(sd, q_ + "output.dense", y) + x, eps)
    return x


# ---------------------------------------------------------------------------
# GroundingDINO: transformer
# ---------------------------------------------------------------------------

def sine_pos_hw(h, w, feats, temperature, device) -> torch.Tensor:
    """PositionEmbeddingSineHW (normalize=True) of an unpadded level:
    (1, 2 * feats, h, w)."""
    not_mask = torch.ones((1, h, w), device=device)
    y = not_mask.cumsum(1)
    x = not_mask.cumsum(2)
    eps, scale = 1e-6, 2 * math.pi
    y = y / (y[:, -1:, :] + eps) * scale
    x = x / (x[:, :, -1:] + eps) * scale
    dim_t = torch.arange(feats, dtype=torch.float32, device=device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor")
                            / feats)
    px = x[:, :, :, None] / dim_t
    py = y[:, :, :, None] / dim_t
    px = torch.stack((px[..., 0::2].sin(), px[..., 1::2].cos()), 4).flatten(3)
    py = torch.stack((py[..., 0::2].sin(), py[..., 1::2].cos()), 4).flatten(3)
    return torch.cat((py, px), 3).permute(0, 3, 1, 2)


def sine_embed(x: torch.Tensor, feats: int, temperature=10000.0):
    """get_sine_pos_embed / gen_sineembed_for_position's per-coordinate
    embedding: (...,) -> (..., feats)."""
    dim_t = torch.arange(feats, dtype=torch.float32, device=x.device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor")
                            / feats)
    s = x[..., None] * (2 * math.pi) / dim_t
    return torch.stack((s[..., 0::2].sin(), s[..., 1::2].cos()),
                       -1).flatten(-2)


def deform_core(value, shapes, loc, aw) -> torch.Tensor:
    """multi_scale_deformable_attn_pytorch: value (B, S, heads, d), loc
    (B, Q, heads, L, P, 2) in [0, 1], aw (B, Q, heads, L, P)."""
    b, _, nh, d = value.shape
    _, q, _, nl, npt, _ = loc.shape
    vals = value.split([h * w for h, w in shapes], 1)
    grids = 2 * loc - 1
    samples = []
    for lv, (h, w) in enumerate(shapes):
        v = vals[lv].flatten(2).transpose(1, 2).reshape(b * nh, d, h, w)
        g = grids[:, :, :, lv].transpose(1, 2).flatten(0, 1)
        samples.append(F.grid_sample(v, g, mode="bilinear",
                                     padding_mode="zeros",
                                     align_corners=False))
    aw = aw.transpose(1, 2).reshape(b * nh, 1, q, nl * npt)
    out = (torch.stack(samples, -2).flatten(-2) * aw).sum(-1)
    return out.view(b, nh * d, q).transpose(1, 2)


def msda(sd, p, query, value, ref, shapes, heads, npt):
    """MSDeformAttn (ms_deform_attn.py) on batch-first tensors."""
    b, q, e = query.shape
    nl = len(shapes)
    v = _lin(sd, p + ".value_proj", value).view(b, -1, heads, e // heads)
    off = _lin(sd, p + ".sampling_offsets", query).view(b, q, heads, nl,
                                                        npt, 2)
    aw = _lin(sd, p + ".attention_weights", query).view(b, q, heads,
                                                        nl * npt)
    aw = aw.softmax(-1).view(b, q, heads, nl, npt)
    if ref.shape[-1] == 2:
        norm = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32,
                            device=query.device)
        loc = ref[:, :, None, :, None, :] \
            + off / norm[None, None, None, :, None, :]
    else:
        loc = ref[:, :, None, :, None, :2] \
            + off / npt * ref[:, :, None, :, None, 2:] * 0.5
    return _lin(sd, p + ".output_proj", deform_core(v, shapes, loc, aw))


def mha(sd, p, q, k, v, heads, bias=None):
    """nn.MultiheadAttention (packed in_proj) on batch-first tensors;
    `bias` an additive mask broadcast to (B, heads, Lq, Lk)."""
    e = q.shape[-1]
    w, bb = sd[p + ".in_proj_weight"], sd[p + ".in_proj_bias"]
    qs = F.linear(q, w[:e], bb[:e])
    ks = F.linear(k, w[e:2 * e], bb[e:2 * e])
    vs = F.linear(v, w[2 * e:], bb[2 * e:])

    def heads_(t):
        return t.view(t.shape[0], t.shape[1], heads, e // heads).transpose(1, 2)

    qs, ks, vs = heads_(qs), heads_(ks), heads_(vs)
    a = (qs * (e // heads) ** -0.5) @ ks.transpose(-1, -2)
    if bias is not None:
        a = a + bias
    o = (a.softmax(-1) @ vs).transpose(1, 2).reshape(q.shape[0], q.shape[1], e)
    return _lin(sd, p + ".out_proj", o)


def fusion(sd, p, v, l, pad, heads):
    """BiAttentionBlock with BiMultiHeadAttention (stable 2-d softmax,
    clamps at +-50000), layer-scale residuals."""
    v = _ln(sd, p + ".layer_norm_v", v, 1e-5)
    l = _ln(sd, p + ".layer_norm_l", l, 1e-5)
    b, nv, _ = v.shape
    nl = l.shape[1]
    inner = sd[p + ".attn.v_proj.weight"].shape[0]
    hd = inner // heads

    def shape(t, n):
        return t.view(b, n, heads, hd).transpose(1, 2).reshape(b * heads, n,
                                                               hd)

    qs = shape(_lin(sd, p + ".attn.v_proj", v) * hd ** -0.5, nv)
    ks = shape(_lin(sd, p + ".attn.l_proj", l), nl)
    vv = shape(_lin(sd, p + ".attn.values_v_proj", v), nv)
    vl = shape(_lin(sd, p + ".attn.values_l_proj", l), nl)
    aw = torch.bmm(qs, ks.transpose(1, 2))
    aw = aw - aw.max()
    aw = aw.clamp(min=-50000, max=50000)
    aw_l = aw.transpose(1, 2)
    aw_l = aw_l - aw_l.max(-1, keepdim=True)[0]
    aw_l = aw_l.clamp(min=-50000, max=50000).softmax(-1)
    m = pad[:, None, None, :].repeat(1, heads, 1, 1).flatten(0, 1)
    aw_v = aw.masked_fill(m, float("-inf")).softmax(-1)
    ov = torch.bmm(aw_v, vl).view(b, heads, nv, hd).transpose(1, 2) \
        .reshape(b, nv, inner)
    ol = torch.bmm(aw_l, vv).view(b, heads, nl, hd).transpose(1, 2) \
        .reshape(b, nl, inner)
    return (v + sd[p + ".gamma_v"] * _lin(sd, p + ".attn.out_v_proj", ov),
            l + sd[p + ".gamma_l"] * _lin(sd, p + ".attn.out_l_proj", ol))


def _ffn(sd, p, x, norm):
    y = _lin(sd, p + ".linear2", F.relu(_lin(sd, p + ".linear1", x)))
    return _ln(sd, f"{p}.{norm}", x + y, 1e-5)


def contrastive(x, text, real, max_len):
    """ContrastiveEmbed: x @ text^T, pads -inf, padded to max_len."""
    res = (x @ text.transpose(-1, -2)).masked_fill(~real[:, None, :],
                                                   float("-inf"))
    out = torch.full((*res.shape[:-1], max_len), float("-inf"),
                     device=res.device)
    out[..., :res.shape[-1]] = res
    return out


def inverse_sigmoid(x, eps=1e-3):
    x = x.clamp(min=0, max=1)
    return torch.log(x.clamp(min=eps) / (1 - x).clamp(min=eps))


def gdino(sd: dict, cfg: dict, image: torch.Tensor, tok: dict,
          select=None) -> dict:
    """GroundingDINO's forward: (1, 3, H, W) normalised image and
    caption_tokens' dict -> pred_logits (1, nq, max_text_len),
    pred_boxes (1, nq, 4), the selection's scores `score` (1, S) and
    indices `topk_idx` (1, nq), and the level shapes. `select` (1, nq)
    decodes that selection in place of the reference's own top-k."""
    dev = image.device
    e, heads = cfg["hidden_dim"], cfg["nheads"]
    ids = torch.as_tensor(tok["ids"], device=dev)[None]
    attn = torch.as_tensor(tok["attn"], device=dev)[None]
    pos = torch.as_tensor(tok["pos"], device=dev)[None]
    real = torch.as_tensor(tok["real"], device=dev)[None]
    pad = ~real

    feats = swin(sd, cfg["swin"], image)
    srcs = [F.group_norm(F.conv2d(f, sd[f"input_proj.{i}.0.weight"],
                                  sd[f"input_proj.{i}.0.bias"]), 32,
                         sd[f"input_proj.{i}.1.weight"],
                         sd[f"input_proj.{i}.1.bias"], 1e-5)
            for i, f in enumerate(feats)]
    n = len(feats)
    srcs.append(F.group_norm(
        F.conv2d(feats[-1], sd[f"input_proj.{n}.0.weight"],
                 sd[f"input_proj.{n}.0.bias"], stride=2, padding=1), 32,
        sd[f"input_proj.{n}.1.weight"], sd[f"input_proj.{n}.1.bias"], 1e-5))
    text = _lin(sd, "feat_map", bert(sd, cfg["bert"], ids, attn, pos))

    shapes = [tuple(s.shape[2:]) for s in srcs]
    src = torch.cat([s.flatten(2).transpose(1, 2) for s in srcs], 1)
    lvl = sd["transformer.level_embed"]
    pos_img = torch.cat([
        sine_pos_hw(h, w, e // 2, cfg["pe_temperatureH"], dev)
        .flatten(2).transpose(1, 2) + lvl[i].view(1, 1, -1)
        for i, (h, w) in enumerate(shapes)], 1)
    refs = []
    for h, w in shapes:
        ry, rx = torch.meshgrid(
            torch.linspace(0.5, h - 0.5, h, device=dev) / h,
            torch.linspace(0.5, w - 0.5, w, device=dev) / w, indexing="ij")
        refs.append(torch.stack((rx.reshape(-1), ry.reshape(-1)), -1))
    enc_ref = torch.cat(refs, 0)[None, :, None].expand(1, -1, len(shapes), 2)
    pos_text = sine_embed(pos.float(), e)
    text_bias = torch.zeros(attn.shape, device=dev).masked_fill(
        ~attn, float("-inf"))[:, None]
    mem = src
    for i in range(cfg["enc_layers"]):
        p = "transformer.encoder."
        mem, text = fusion(sd, f"{p}fusion_layers.{i}", mem, text, pad,
                           heads // 2)
        tl = f"{p}text_layers.{i}"
        q = text + pos_text
        text = _ln(sd, tl + ".norm1",
                   text + mha(sd, tl + ".self_attn", q, q, text, heads // 2,
                              text_bias), 1e-5)
        text = _ffn(sd, tl, text, "norm2")
        el = f"{p}layers.{i}"
        mem = _ln(sd, el + ".norm1",
                  mem + msda(sd, el + ".self_attn", mem + pos_img, mem,
                             enc_ref, shapes, heads, cfg["enc_n_points"]),
                  1e-5)
        mem = _ffn(sd, el, mem, "norm2")

    # language-guided query selection (gen_encoder_output_proposals)
    props = []
    for lv, (h, w) in enumerate(shapes):
        gy, gx = torch.meshgrid(torch.linspace(0, h - 1, h, device=dev),
                                torch.linspace(0, w - 1, w, device=dev),
                                indexing="ij")
        grid = (torch.stack((gx, gy), -1) + 0.5) / torch.tensor(
            [w, h], dtype=torch.float32, device=dev)
        wh = torch.ones_like(grid) * 0.05 * (2.0 ** lv)
        props.append(torch.cat((grid, wh), -1).view(1, -1, 4))
    props = torch.cat(props, 1)
    valid = ((props > 0.01) & (props < 0.99)).all(-1, keepdim=True)
    props = torch.log(props / (1 - props)).masked_fill(~valid, float("inf"))
    out_mem = mem.masked_fill(~valid, 0.0)
    out_mem = _ln(sd, "transformer.enc_output_norm",
                  _lin(sd, "transformer.enc_output", out_mem), 1e-5)
    score = contrastive(out_mem, text, real, cfg["max_text_len"]).max(-1)[0]
    nq = cfg["num_queries"]
    idx = torch.topk(score, nq, dim=1)[1] if select is None else select
    coords = _mlp(sd, "transformer.enc_out_bbox_embed", out_mem, 3) + props
    ref_unsig = torch.gather(coords, 1, idx[..., None].repeat(1, 1, 4))

    # decoder (TransformerDecoder, DeformableTransformerDecoderLayer)
    tgt = sd["transformer.tgt_embed.weight"][None]
    ref = ref_unsig.sigmoid()
    refs = [ref]
    hs = []
    text_pad_bias = torch.zeros(pad.shape, device=dev).masked_fill(
        pad, float("-inf"))[:, None, None]
    for i in range(cfg["dec_layers"]):
        p = f"transformer.decoder.layers.{i}"
        ref_in = ref[:, :, None].expand(-1, -1, len(shapes), 4)
        sine = torch.cat([sine_embed(ref_in[:, :, 0, j], e // 2)
                          for j in (1, 0, 2, 3)], -1)
        qpos = _mlp(sd, "transformer.decoder.ref_point_head", sine, 2)
        q = tgt + qpos
        tgt = _ln(sd, p + ".norm2",
                  tgt + mha(sd, p + ".self_attn", q, q, tgt, heads), 1e-5)
        tgt = _ln(sd, p + ".catext_norm",
                  tgt + mha(sd, p + ".ca_text", tgt + qpos, text, text, heads,
                            text_pad_bias), 1e-5)
        tgt = _ln(sd, p + ".norm1",
                  tgt + msda(sd, p + ".cross_attn", tgt + qpos, mem, ref_in,
                             shapes, heads, cfg["dec_n_points"]), 1e-5)
        tgt = _ffn(sd, p, tgt, "norm3")
        ref = (_mlp(sd, f"bbox_embed.{i}", tgt, 3)
               + inverse_sigmoid(ref)).sigmoid()
        refs.append(ref)
        hs.append(_ln(sd, "transformer.decoder.norm", tgt, 1e-5))
    last = cfg["dec_layers"] - 1
    boxes = (_mlp(sd, f"bbox_embed.{last}", hs[last], 3)
             + inverse_sigmoid(refs[last])).sigmoid()
    logits = contrastive(hs[last], text, real, cfg["max_text_len"])
    return {"pred_logits": logits, "pred_boxes": boxes, "score": score,
            "topk_idx": idx, "shapes": shapes}


# ---------------------------------------------------------------------------
# SAM ViT-H (modeling/image_encoder.py, prompt_encoder.py, mask_decoder.py,
# transformer.py; predictor.py)
# ---------------------------------------------------------------------------

def sam_size(h: int, w: int, long_side: int) -> tuple:
    """ResizeLongestSide.get_preprocess_shape."""
    scale = long_side * 1.0 / max(h, w)
    return int(h * scale + 0.5), int(w * scale + 0.5)


def _rel_pos(q_size, k_size, table):
    max_rel = 2 * max(q_size, k_size) - 1
    if table.shape[0] != max_rel:
        table = F.interpolate(table.reshape(1, table.shape[0], -1)
                              .permute(0, 2, 1), size=max_rel,
                              mode="linear").reshape(-1, max_rel).permute(1, 0)
    qc = torch.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    kc = torch.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    rel = (qc - kc) + (k_size - 1) * max(q_size / k_size, 1.0)
    return table[rel.long().to(table.device)]


def _vit_attn(sd, p, x, heads, rel_pos=True):
    b, h, w, _ = x.shape
    qkv = _lin(sd, p + ".qkv", x).reshape(b, h * w, 3, heads, -1) \
        .permute(2, 0, 3, 1, 4)
    q, k, v = qkv.reshape(3, b * heads, h * w, -1).unbind(0)
    hd = q.shape[-1]
    attn = (q * hd ** -0.5) @ k.transpose(-2, -1)
    if rel_pos:
        rh = _rel_pos(h, h, sd[p + ".rel_pos_h"])
        rw = _rel_pos(w, w, sd[p + ".rel_pos_w"])
        rq = q.reshape(b * heads, h, w, hd)
        rel_h = torch.einsum("bhwc,hkc->bhwk", rq, rh)
        rel_w = torch.einsum("bhwc,wkc->bhwk", rq, rw)
        attn = (attn.view(b * heads, h, w, h, w) + rel_h[:, :, :, :, None]
                + rel_w[:, :, :, None, :]).view(b * heads, h * w, h * w)
    x = (attn.softmax(-1) @ v).view(b, heads, h, w, -1) \
        .permute(0, 2, 3, 1, 4).reshape(b, h, w, -1)
    return _lin(sd, p + ".proj", x)


def _ln2d(sd, p, x, eps=1e-6):
    u = x.mean(1, keepdim=True)
    s = (x - u).pow(2).mean(1, keepdim=True)
    x = (x - u) / torch.sqrt(s + eps)
    return sd[p + ".weight"][:, None, None] * x + sd[p + ".bias"][:, None, None]


def sam_image(image: np.ndarray, cfg: dict, device):
    """SamPredictor.set_image's input: (1, 3, S, S) and (nh, nw)."""
    x = torch.as_tensor(np.asarray(image, np.float32), device=device)
    s = cfg["image_size"]
    hw = sam_size(x.shape[0], x.shape[1], s)
    x = _resize(x, hw)
    mean = torch.tensor(SAM_PIXEL_MEAN, device=device)[None, :, None, None]
    std = torch.tensor(SAM_PIXEL_STD, device=device)[None, :, None, None]
    x = (x - mean) / std
    return F.pad(x, (0, s - hw[1], 0, s - hw[0])), hw


def sam_encoder(sd: dict, cfg: dict, x: torch.Tensor,
                rel_pos: bool = True) -> torch.Tensor:
    """ImageEncoderViT: (1, 3, 1024, 1024) -> (1, 256, 64, 64)."""
    p = "image_encoder."
    ps = cfg["vit_patch_size"]
    x = F.conv2d(x, sd[p + "patch_embed.proj.weight"],
                 sd[p + "patch_embed.proj.bias"], stride=ps)
    x = x.permute(0, 2, 3, 1) + sd[p + "pos_embed"]
    heads, ws = cfg["encoder_num_heads"], cfg["window_size"]
    for i in range(cfg["encoder_depth"]):
        bp = f"{p}blocks.{i}"
        short = x
        x = _ln(sd, bp + ".norm1", x, 1e-6)
        if i not in cfg["encoder_global_attn_indexes"]:
            b, h, w, c = x.shape
            ph, pw = (ws - h % ws) % ws, (ws - w % ws) % ws
            xp = F.pad(x, (0, 0, 0, pw, 0, ph))
            hp, wp = h + ph, w + pw
            win = xp.view(b, hp // ws, ws, wp // ws, ws, c) \
                .permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c)
            win = _vit_attn(sd, bp + ".attn", win, heads, rel_pos)
            x = win.view(b, hp // ws, wp // ws, ws, ws, -1) \
                .permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)[:, :h, :w]
        else:
            x = _vit_attn(sd, bp + ".attn", x, heads, rel_pos)
        x = short + x
        y = _ln(sd, bp + ".norm2", x, 1e-6)
        x = x + _lin(sd, bp + ".mlp.lin2", F.gelu(_lin(sd, bp + ".mlp.lin1",
                                                       y)))
    x = F.conv2d(x.permute(0, 3, 1, 2), sd[p + "neck.0.weight"])
    x = _ln2d(sd, p + "neck.1", x)
    x = F.conv2d(x, sd[p + "neck.2.weight"], padding=1)
    return _ln2d(sd, p + "neck.3", x)


def _pe(sd, coords):
    g = sd["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"]
    c = 2 * math.pi * ((2 * coords - 1) @ g)
    return torch.cat([c.sin(), c.cos()], -1)


def _dec_attn(sd, p, q, k, v, heads):
    q, k, v = (_lin(sd, f"{p}.{n}_proj", t) for n, t in
               (("q", q), ("k", k), ("v", v)))

    def sep(t):
        b, n, c = t.shape
        return t.reshape(b, n, heads, c // heads).transpose(1, 2)

    q, k, v = sep(q), sep(k), sep(v)
    a = (q @ k.permute(0, 1, 3, 2)) / math.sqrt(q.shape[-1])
    o = a.softmax(-1) @ v
    b, nh, n, c = o.shape
    return _lin(sd, p + ".out_proj", o.transpose(1, 2).reshape(b, n, nh * c))


def sam_decode(sd: dict, cfg: dict, emb: torch.Tensor, boxes: torch.Tensor,
               in_hw, orig_hw) -> torch.Tensor:
    """predict_torch(boxes=..., multimask_output=False) on xyxy boxes in
    the original image's pixels: mask logits (n, 1, H, W)."""
    dev = emb.device
    s = cfg["image_size"]
    gs = s // cfg["vit_patch_size"]
    (nh, nw), (h, w) = in_hw, orig_hw
    b = boxes.clone()
    b[:, 0::2] *= nw / w
    b[:, 1::2] *= nh / h
    coords = (b + 0.5).reshape(-1, 2, 2) / s
    corner = _pe(sd, coords)
    corner[:, 0] += sd["prompt_encoder.point_embeddings.2.weight"][0]
    corner[:, 1] += sd["prompt_encoder.point_embeddings.3.weight"][0]
    n = corner.shape[0]
    dense = sd["prompt_encoder.no_mask_embed.weight"].reshape(1, -1, 1, 1) \
        .expand(n, -1, gs, gs)
    grid = torch.ones((gs, gs), device=dev)
    ye = (grid.cumsum(0) - 0.5) / gs
    xe = (grid.cumsum(1) - 0.5) / gs
    pe = _pe(sd, torch.stack([xe, ye], -1)).permute(2, 0, 1)[None]

    p = "mask_decoder."
    out_tok = torch.cat([sd[p + "iou_token.weight"],
                         sd[p + "mask_tokens.weight"]], 0)
    tokens = torch.cat([out_tok[None].expand(n, -1, -1), corner], 1)
    src = torch.repeat_interleave(emb, n, 0) + dense
    pos = torch.repeat_interleave(pe, n, 0)
    bb, c, hh, ww = src.shape
    keys = src.flatten(2).permute(0, 2, 1)
    kpe = pos.flatten(2).permute(0, 2, 1)
    queries = tokens
    heads = cfg["decoder_heads"]
    for i in range(cfg["decoder_depth"]):
        lp = f"{p}transformer.layers.{i}"
        if i == 0:
            queries = _dec_attn(sd, lp + ".self_attn", queries, queries,
                                queries, heads)
        else:
            q = queries + tokens
            queries = queries + _dec_attn(sd, lp + ".self_attn", q, q,
                                          queries, heads)
        queries = _ln(sd, lp + ".norm1", queries, 1e-5)
        q, k = queries + tokens, keys + kpe
        queries = _ln(sd, lp + ".norm2", queries + _dec_attn(
            sd, lp + ".cross_attn_token_to_image", q, k, keys, heads), 1e-5)
        y = _lin(sd, lp + ".mlp.lin2", F.relu(_lin(sd, lp + ".mlp.lin1",
                                                   queries)))
        queries = _ln(sd, lp + ".norm3", queries + y, 1e-5)
        q, k = queries + tokens, keys + kpe
        keys = _ln(sd, lp + ".norm4", keys + _dec_attn(
            sd, lp + ".cross_attn_image_to_token", k, q, queries, heads),
            1e-5)
    q, k = queries + tokens, keys + kpe
    queries = _ln(sd, p + "transformer.norm_final_attn", queries + _dec_attn(
        sd, p + "transformer.final_attn_token_to_image", q, k, keys, heads),
        1e-5)
    up = keys.transpose(1, 2).view(bb, c, hh, ww)
    up = F.conv_transpose2d(up, sd[p + "output_upscaling.0.weight"],
                            sd[p + "output_upscaling.0.bias"], stride=2)
    up = F.gelu(_ln2d(sd, p + "output_upscaling.1", up))
    up = F.gelu(F.conv_transpose2d(up, sd[p + "output_upscaling.3.weight"],
                                   sd[p + "output_upscaling.3.bias"],
                                   stride=2))
    nm = cfg["num_multimask_outputs"] + 1
    hyper = torch.stack([_mlp(sd, f"{p}output_hypernetworks_mlps.{i}",
                              queries[:, 1 + i], 3) for i in range(nm)], 1)
    b2, c2, h2, w2 = up.shape
    masks = (hyper @ up.view(b2, c2, h2 * w2)).view(b2, -1, h2, w2)[:, 0:1]
    masks = F.interpolate(masks, (s, s), mode="bilinear", align_corners=False)
    masks = masks[..., :nh, :nw]
    return F.interpolate(masks, (h, w), mode="bilinear", align_corners=False)


# ---------------------------------------------------------------------------
# the request
# ---------------------------------------------------------------------------

def rerank(prob: np.ndarray, first: float, prev: float) -> np.ndarray:
    """The greedy cutoff of res_model.py:384-399: in descending order,
    keep while prob >= first x the top and >= prev x the one before."""
    order = np.argsort(-np.asarray(prob, np.float64), kind="stable")
    n = 1
    while n < len(order) and prob[order[n]] >= first * prob[order[0]] \
            and prob[order[n]] >= prev * prob[order[n - 1]]:
        n += 1
    return order[:n]


@torch.no_grad()
def res_request(dino_sd: dict, dino_cfg: dict, sam_sd: dict, sam_cfg: dict,
                vocab: dict, image: np.ndarray, prompt: str,
                box_threshold: float, select=None, sam_rel_pos=True) -> dict:
    """The RES request from a float [0, 1] (H, W, 3) view: the detector's
    outputs, the queries whose score passes `box_threshold` (`keep`, in
    query order), their xyxy pixel boxes, SAM's image embedding, and the
    union mask's logit (the largest logit of the re-ranked masks) and
    mask; `mask` is None where no box passes."""
    dev = dino_sd["feat_map.weight"].device
    h, w = image.shape[:2]
    tok = caption_tokens(prompt, vocab, dino_cfg["text_pad"])
    out = gdino(dino_sd, dino_cfg, dino_image(image, dino_cfg, dev), tok,
                select)
    scores = out["pred_logits"][0].sigmoid().max(-1)[0]
    keep = torch.nonzero(scores > box_threshold)[:, 0]
    bx = out["pred_boxes"][0, keep] * torch.tensor([w, h, w, h],
                                                   dtype=torch.float32,
                                                   device=dev)
    xyxy = torch.cat([bx[:, :2] - bx[:, 2:] / 2, bx[:, :2] + bx[:, 2:] / 2],
                     1)
    x, in_hw = sam_image(image, sam_cfg, dev)
    emb = sam_encoder(sam_sd, sam_cfg, x, sam_rel_pos)
    res = dict(out, keep=keep.cpu().numpy(), xyxy=xyxy, embedding=emb,
               mask_logit=None, mask=None)
    if len(keep) == 0:
        return res
    logits = sam_decode(sam_sd, sam_cfg, emb, xyxy, in_hw, (h, w))[:, 0]
    sc = scores[keep].double().cpu().numpy()
    kept = rerank(sc, 0.99, 0.9)
    kept = kept[rerank(sc[kept], 0.8, 0.8)]
    res["mask_logit"] = logits[torch.as_tensor(kept, device=dev)].amax(0)
    res["mask"] = res["mask_logit"] > 0.0
    return res
