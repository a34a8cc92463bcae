"""GroundingDINO, the open-vocabulary text -> boxes detector.

Counterpart of goi_tpu/query/grounding.py: the RES pipeline's detector
(ref:guidance/res_model.py:205-238, ref:ext/GroundingDINO/groundingdino/
models/GroundingDINO/{groundingdino,transformer,fuse_modules}.py):

  Swin image backbone (query/swin.py)  +  BERT text tower (query/bert.py)
    -> input projections (conv1x1 + GroupNorm32, one extra conv3x3/s2)
    -> feature-enhancer layers: bidirectional image<->text fusion
       (BiAttentionBlock), text self-attention, multi-scale deformable
       image self-attention (query/deform_attn.py)
    -> language-guided query selection (two_stage_type="standard"):
       contrastive logits per location against the fused text, the
       top-900 proposals (ref:transformer.py:284-327)
    -> cross-modality decoder layers: query self-attention, text
       cross-attention, deformable image cross-attention, iterative box
       refinement (ref:transformer.py:802-927)
    -> ContrastiveEmbed logits over the text tokens + sigmoid boxes.

`GroundingDINO`'s state_dict keys are the official
groundingdino_swint_ogc.pth names, so `load_groundingdino_params` is a
torch.load, a "module." strip and a drop of the buffers and aliases the
model rebuilds. As in the JAX package the image is resized to a fixed
square and the text padded to a fixed length; the boxes are normalized
cxcywh, so the square resize maps back to the frame exactly.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from goi_tpu_torch.query._nn import (MLP, fan_in, group_norm, init_by_rule_,
                                     layer_norm, linear, merge_heads, randn,
                                     split_heads)
from goi_tpu_torch.query.bert import (BERT_BASE, BERT_TINY_TEST, BertConfig,
                                      BertModel, BertTokenizer,
                                      bert_param_shapes, special_token_masks)
from goi_tpu_torch.query.deform_attn import MSDeformAttn
from goi_tpu_torch.query.swin import (SWIN_T, SWIN_TINY_TEST, SwinBackbone,
                                      SwinConfig, swin_param_shapes)
from goi_tpu_torch.utils.image import resize_linear


@dataclasses.dataclass(frozen=True)
class GroundingConfig:
    d_model: int = 256
    heads: int = 8
    enc_layers: int = 6
    dec_layers: int = 6
    ffn: int = 2048
    n_points: int = 4
    num_queries: int = 900
    max_text_len: int = 256
    text_pad: int = 64          # fixed tokenized-caption length
    img_size: int = 800         # fixed square input
    pe_temperature: float = 20.0  # ref:config pe_temperatureH/W
    swin: SwinConfig = SWIN_T
    bert: BertConfig = BERT_BASE

    @property
    def levels(self) -> int:
        return len(self.swin.out_indices) + 1


GDINO_SWINT = GroundingConfig()
GDINO_TINY_TEST = GroundingConfig(
    d_model=32, heads=4, enc_layers=2, dec_layers=2, ffn=64,
    num_queries=20, max_text_len=40, text_pad=16, img_size=64,
    swin=SWIN_TINY_TEST, bert=BERT_TINY_TEST)
EPS = 1e-5   # torch nn.LayerNorm's default


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

class MHA(nn.Module):
    """torch nn.MultiheadAttention's names (packed in_proj), plain
    matmul + softmax attention."""

    def __init__(self, e: int, heads: int, device):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * e, e,
                                                       device=device))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * e, device=device))
        self.out_proj = linear(e, e, device=device)

    def forward(self, q, k, v, attn_bias=None):
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        qh = split_heads(F.linear(q, wq, bq), self.heads)
        kh = split_heads(F.linear(k, wk, bk), self.heads)
        vh = split_heads(F.linear(v, wv, bv), self.heads)
        a = qh @ kh.transpose(-1, -2) / math.sqrt(qh.shape[-1])
        if attn_bias is not None:
            a = a + attn_bias
        return self.out_proj(merge_heads(torch.softmax(a, -1) @ vh))


def _sine_embed_1d(x: torch.Tensor, num_feats: int,
                   temperature: float = 10000.0) -> torch.Tensor:
    """x (...,) -> (..., num_feats) interleaved sin/cos
    (ref:GroundingDINO/utils.py:24-53 sine_func)."""
    dim_t = torch.as_tensor(
        temperature ** (2 * (np.arange(num_feats) // 2) / num_feats),
        dtype=torch.float32, device=x.device)
    s = x[..., None] * (2 * math.pi) / dim_t
    return torch.stack([torch.sin(s[..., 0::2]), torch.cos(s[..., 1::2])],
                       -1).reshape(*x.shape, num_feats)


def sine_pos_embed_hw(h: int, w: int, num_feats: int,
                      temperature: float) -> np.ndarray:
    """PositionEmbeddingSineHW with no padding (mask all valid),
    normalize=True (ref:backbone/position_encoding.py:86-136).
    Returns (h*w, 2*num_feats) [pos_y | pos_x]."""
    eps = 1e-6
    y = (np.arange(h, dtype=np.float32) + 1.0) / (h + eps) * 2 * math.pi
    x = (np.arange(w, dtype=np.float32) + 1.0) / (w + eps) * 2 * math.pi
    dim_t = temperature ** (2 * (np.arange(num_feats) // 2) / num_feats)
    py = y[:, None] / dim_t
    px = x[:, None] / dim_t
    py = np.stack([np.sin(py[:, 0::2]), np.cos(py[:, 1::2])],
                  -1).reshape(h, num_feats)
    px = np.stack([np.sin(px[:, 0::2]), np.cos(px[:, 1::2])],
                  -1).reshape(w, num_feats)
    grid = np.concatenate([
        np.broadcast_to(py[:, None], (h, w, num_feats)),
        np.broadcast_to(px[None, :], (h, w, num_feats))], -1)
    return grid.reshape(h * w, 2 * num_feats).astype(np.float32)


def _inverse_sigmoid(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1.0 - x).clamp(min=eps))


def _contrastive(x, text, text_pad_mask, max_text_len):
    """ContrastiveEmbed (ref:GroundingDINO/utils.py:233-268):
    x (b, nq, E) @ text (b, nl, E)^T, padding -> -inf, padded out to
    max_text_len."""
    res = (x @ text.transpose(1, 2)).masked_fill(text_pad_mask[:, None, :],
                                                 float("-inf"))
    return F.pad(res, (0, max_text_len - res.shape[-1]),
                 value=float("-inf"))


# ---------------------------------------------------------------------------
# feature enhancer (encoder)
# ---------------------------------------------------------------------------

class FusionLayer(nn.Module):
    """BiAttentionBlock: bidirectional image<->text attention with
    layer-scale residuals (ref:fuse_modules.py:99-295)."""

    def __init__(self, e: int, inner: int, heads: int, device):
        super().__init__()
        self.heads = heads
        self.layer_norm_v = layer_norm(e, eps=EPS, device=device)
        self.layer_norm_l = layer_norm(e, eps=EPS, device=device)
        self.attn = nn.ModuleDict(
            {n: linear(e, inner, device=device)
             for n in ("v_proj", "l_proj", "values_v_proj",
                       "values_l_proj")})
        self.attn["out_v_proj"] = linear(inner, e, device=device)
        self.attn["out_l_proj"] = linear(inner, e, device=device)
        self.gamma_v = nn.Parameter(torch.zeros(e, device=device))
        self.gamma_l = nn.Parameter(torch.zeros(e, device=device))

    def forward(self, v, l, text_pad_mask):
        """v (bs, nv, E) image, l (bs, nl, E) text; text_pad_mask
        (bs, nl) True = padding."""
        at, h = self.attn, self.heads
        vn = self.layer_norm_v(v)
        ln_ = self.layer_norm_l(l)
        qs = split_heads(at["v_proj"](vn), h)
        qs = qs * qs.shape[-1] ** -0.5
        ks = split_heads(at["l_proj"](ln_), h)
        vv = split_heads(at["values_v_proj"](vn), h)
        vl = split_heads(at["values_l_proj"](ln_), h)

        aw = qs @ ks.transpose(-1, -2)              # (b, h, nv, nl)
        aw = (aw - aw.max()).clamp(-50000.0, 50000.0)  # stable_softmax_2d
        aw_t = aw.transpose(-1, -2)                 # (b, h, nl, nv)
        aw_l = (aw_t - aw_t.max(-1, keepdim=True).values
                ).clamp(-50000.0, 50000.0)
        # mask language for vision (no image padding here, so only this
        # direction is masked; ref:fuse_modules.py:205-219)
        aw_v = aw.masked_fill(text_pad_mask[:, None, None, :], -1e9)
        out_v = merge_heads(torch.softmax(aw_v, -1) @ vl)
        out_l = merge_heads(torch.softmax(aw_l, -1) @ vv)
        return (vn + self.gamma_v * at["out_v_proj"](out_v),
                ln_ + self.gamma_l * at["out_l_proj"](out_l))


class _FFN(nn.Module):
    """linear1 -> relu -> linear2, residual, post-norm."""

    def __init__(self, e: int, hid: int, norm: str, device):
        super().__init__()
        self.linear1 = linear(e, hid, device=device)
        self.linear2 = linear(hid, e, device=device)
        self.add_module(norm, layer_norm(e, eps=EPS, device=device))
        self._norm = norm

    def ffn(self, x):
        return getattr(self, self._norm)(
            x + self.linear2(F.relu(self.linear1(x))))


class TextEnhanceLayer(_FFN):
    """Vanilla post-norm encoder layer on the text
    (ref:transformer_vanilla.py:72-123)."""

    def __init__(self, e: int, hid: int, heads: int, device):
        super().__init__(e, hid, "norm2", device)
        self.self_attn = MHA(e, heads, device)
        self.norm1 = layer_norm(e, eps=EPS, device=device)

    def forward(self, src, attn_mask_3d, pos):
        """attn_mask_3d (bs, L, L) True = attend (the bertwarper
        sub-sentence mask)."""
        bias = torch.where(attn_mask_3d[:, None], 0.0, -1e9)
        q = src + pos
        src = self.norm1(src + self.self_attn(q, q, src, attn_bias=bias))
        return self.ffn(src)


class EncoderLayer(_FFN):
    """DeformableTransformerEncoderLayer (ref:transformer.py:738-799)."""

    def __init__(self, cfg: GroundingConfig, device):
        e = cfg.d_model
        super().__init__(e, cfg.ffn, "norm2", device)
        self.self_attn = MSDeformAttn(e, cfg.heads, cfg.levels,
                                      cfg.n_points, device)
        self.norm1 = layer_norm(e, eps=EPS, device=device)

    def forward(self, src, pos, ref_points, shapes):
        src = self.norm1(src + self.self_attn(src + pos, src, ref_points,
                                              shapes))
        return self.ffn(src)


class DecoderLayer(_FFN):
    """DeformableTransformerDecoderLayer: self-attn -> text cross-attn
    -> deformable image cross-attn -> FFN (ref:transformer.py:868-927)."""

    def __init__(self, cfg: GroundingConfig, device):
        e = cfg.d_model
        super().__init__(e, cfg.ffn, "norm3", device)
        self.cross_attn = MSDeformAttn(e, cfg.heads, cfg.levels,
                                       cfg.n_points, device)
        self.norm1 = layer_norm(e, eps=EPS, device=device)
        self.ca_text = MHA(e, cfg.heads, device)
        self.catext_norm = layer_norm(e, eps=EPS, device=device)
        self.self_attn = MHA(e, cfg.heads, device)
        self.norm2 = layer_norm(e, eps=EPS, device=device)

    def forward(self, tgt, query_pos, ref_points, memory, shapes,
                memory_text, text_pad_mask):
        q = tgt + query_pos
        tgt = self.norm2(tgt + self.self_attn(q, q, tgt))
        bias = torch.where(text_pad_mask[:, None, None, :], -1e9, 0.0)
        tgt = self.catext_norm(tgt + self.ca_text(
            tgt + query_pos, memory_text, memory_text, attn_bias=bias))
        tgt = self.norm1(tgt + self.cross_attn(tgt + query_pos, memory,
                                               ref_points, shapes))
        return self.ffn(tgt)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

class GroundingDINO(nn.Module):
    """image + tokenized caption -> pred_logits (B, nq, max_text_len) and
    pred_boxes (B, nq, 4) (ref:groundingdino.py:212-349; goi_tpu's
    grounding_forward), in three steps a caller may also take one by
    one: `encode` (towers, projections, feature enhancer), `select`
    (the top-k query selection) and `decode`."""

    def __init__(self, cfg: GroundingConfig = GDINO_SWINT, device="cuda"):
        super().__init__()
        self.cfg = cfg
        e = cfg.d_model
        self.backbone = nn.ModuleList([SwinBackbone(cfg.swin, device)])
        self.bert = BertModel(cfg.bert, device)
        self.feat_map = linear(cfg.bert.hidden, e, device=device)
        chans = [cfg.swin.num_features[i] for i in cfg.swin.out_indices]
        self.input_proj = nn.ModuleList(
            nn.Sequential(nn.Conv2d(c, e, 1, device=device),
                          group_norm(32, e, eps=EPS, device=device))
            for c in chans)
        self.input_proj.append(nn.Sequential(
            nn.Conv2d(chans[-1], e, 3, stride=2, padding=1, device=device),
            group_norm(32, e, eps=EPS, device=device)))
        fd, half = cfg.ffn // 2, max(1, cfg.heads // 2)
        t = nn.Module()
        t.level_embed = nn.Parameter(torch.zeros(cfg.levels, e,
                                                 device=device))
        t.encoder = nn.Module()
        t.encoder.layers = nn.ModuleList(
            EncoderLayer(cfg, device) for _ in range(cfg.enc_layers))
        t.encoder.text_layers = nn.ModuleList(
            TextEnhanceLayer(e, fd, half, device)
            for _ in range(cfg.enc_layers))
        t.encoder.fusion_layers = nn.ModuleList(
            FusionLayer(e, fd, half, device) for _ in range(cfg.enc_layers))
        t.decoder = nn.Module()
        t.decoder.layers = nn.ModuleList(
            DecoderLayer(cfg, device) for _ in range(cfg.dec_layers))
        t.decoder.norm = layer_norm(e, eps=EPS, device=device)
        t.decoder.ref_point_head = MLP((2 * e, e, e), device)
        t.tgt_embed = nn.Embedding(cfg.num_queries, e, device=device)
        t.enc_output = linear(e, e, device=device)
        t.enc_output_norm = layer_norm(e, eps=EPS, device=device)
        t.enc_out_bbox_embed = MLP((e, e, e, 4), device)
        self.transformer = t
        self.bbox_embed = nn.ModuleList(MLP((e, e, e, 4), device)
                                        for _ in range(cfg.dec_layers))

    def forward(self, image, input_ids, text_attn_3d, position_ids,
                text_pad_mask) -> dict:
        """image (B, 3, S, S) ImageNet-normalized; input_ids (B, L);
        text_attn_3d (B, L, L) bool sub-sentence mask; position_ids
        (B, L); text_pad_mask (B, L) True = padding."""
        enc = self.encode(image, input_ids, text_attn_3d, position_ids,
                          text_pad_mask)
        return self.decode(enc, self.select(enc))

    def encode(self, image, input_ids, text_attn_3d, position_ids,
               text_pad_mask) -> dict:
        """Towers, input projections and the feature enhancer
        (ref:groundingdino.py:291-310, transformer.py:221-283)."""
        cfg, t = self.cfg, self.transformer
        b, e = image.shape[0], cfg.d_model
        dev = image.device
        feats = self.backbone[0](image)
        txt = self.feat_map(self.bert(input_ids, text_attn_3d,
                                      position_ids))
        srcs = [proj(f) for proj, f in zip(self.input_proj, feats)]
        srcs.append(self.input_proj[-1](feats[-1]))
        shapes = tuple((s.shape[2], s.shape[3]) for s in srcs)
        src_flat = torch.cat([s.reshape(b, e, -1).transpose(1, 2)
                              for s in srcs], 1)
        pos_flat = torch.cat([
            torch.as_tensor(sine_pos_embed_hw(h, wd, e // 2,
                                              cfg.pe_temperature),
                            device=dev)[None] + t.level_embed[lv][None, None]
            for lv, (h, wd) in enumerate(shapes)], 1).expand_as(src_flat)

        # reference points: per-location normalized centres, one per
        # level (valid_ratios == 1, no padding)
        refs = np.concatenate([
            np.stack(np.meshgrid((np.arange(wd) + 0.5) / wd,
                                 (np.arange(h) + 0.5) / h,
                                 indexing="xy"), -1).reshape(-1, 2)
            for (h, wd) in shapes], 0).astype(np.float32)
        enc_ref = torch.as_tensor(refs, device=dev)[None, :, None].expand(
            b, refs.shape[0], len(shapes), 2)
        pos_text = _sine_embed_1d(position_ids.float(), e)
        mem, mem_text = src_flat, txt
        for fl, tl, el in zip(t.encoder.fusion_layers, t.encoder.text_layers,
                              t.encoder.layers):
            mem, mem_text = fl(mem, mem_text, text_pad_mask)
            mem_text = tl(mem_text, text_attn_3d, pos_text)
            mem = el(mem, pos_flat, enc_ref, shapes)
        return {"memory": mem, "memory_text": mem_text, "shapes": shapes,
                "text_pad_mask": text_pad_mask}

    def _proposals(self, shapes, device):
        """Per-location anchor boxes in inverse-sigmoid space (+inf where
        invalid) and their validity (ref:GroundingDINO/utils.py:56-116)."""
        props = []
        for lvl, (h, wd) in enumerate(shapes):
            grid = np.stack(np.meshgrid(
                (np.arange(wd, dtype=np.float32) + 0.5) / wd,
                (np.arange(h, dtype=np.float32) + 0.5) / h,
                indexing="xy"), -1).reshape(-1, 2)
            wh = np.full_like(grid, 0.05 * (2.0 ** lvl))
            props.append(np.concatenate([grid, wh], -1))
        props = np.concatenate(props, 0)
        valid = ((props > 0.01) & (props < 0.99)).all(-1)
        unsig = np.log(props / (1 - props)).astype(np.float32)
        unsig = np.where(valid[:, None], unsig, np.inf)
        return (torch.as_tensor(unsig, device=device)[None],
                torch.as_tensor(valid, device=device))

    def select(self, enc: dict) -> dict:
        """Language-guided query selection (two-stage "standard",
        ref:transformer.py:284-327): the encoder output's contrastive
        `score` (B, S), the indices `topk_idx` (B, num_queries) of the
        top ones, highest first, and the normed output `out_mem` and
        anchors `props_unsig` that the decoder's proposals come from."""
        t = self.transformer
        mem = enc["memory"]
        props_unsig, valid = self._proposals(enc["shapes"], mem.device)
        out_mem = t.enc_output_norm(t.enc_output(
            mem * valid.float()[None, :, None]))
        enc_logits = _contrastive(out_mem, enc["memory_text"],
                                  enc["text_pad_mask"], self.cfg.max_text_len)
        score = enc_logits.max(-1).values
        idx = torch.topk(score, self.cfg.num_queries, dim=-1,
                         sorted=True).indices
        return {"score": score, "topk_idx": idx, "out_mem": out_mem,
                "props_unsig": props_unsig}

    def decode(self, enc: dict, sel: dict) -> dict:
        """The decoder with iterative box refinement from the selected
        proposals (ref:transformer.py:633-735, groundingdino.py:317-335)."""
        cfg, t = self.cfg, self.transformer
        e, nq = cfg.d_model, cfg.num_queries
        mem, mem_text = enc["memory"], enc["memory_text"]
        shapes, pad = enc["shapes"], enc["text_pad_mask"]
        b = mem.shape[0]
        coords_unsig = t.enc_out_bbox_embed(sel["out_mem"]) \
            + sel["props_unsig"]
        ref = torch.sigmoid(torch.gather(
            coords_unsig, 1, sel["topk_idx"][..., None].expand(-1, -1, 4)))
        tgt = t.tgt_embed.weight[None].expand(b, nq, e)
        ref_last_in = ref
        for i, lyr in enumerate(t.decoder.layers):
            # query pos: sine embed of (cy, cx, w, h) -> MLP
            sine = torch.cat([_sine_embed_1d(ref[..., j], e // 2)
                              for j in (1, 0, 2, 3)], -1)
            query_pos = t.decoder.ref_point_head(sine)
            ref_in = ref[:, :, None].expand(b, nq, len(shapes), 4)
            tgt = lyr(tgt, query_pos, ref_in, mem, shapes, mem_text, pad)
            ref_last_in = ref
            # in-loop anchor update from the raw layer output
            # (ref:transformer.py:716-728)
            ref = torch.sigmoid(self.bbox_embed[i](tgt)
                                + _inverse_sigmoid(ref))
        # the reported heads run on the normed hidden states with the ref
        # that entered the last layer (ref:groundingdino.py:317-335)
        hs = t.decoder.norm(tgt)
        logits = _contrastive(hs, mem_text, pad, cfg.max_text_len)
        boxes = torch.sigmoid(self.bbox_embed[cfg.dec_layers - 1](hs)
                              + _inverse_sigmoid(ref_last_in))
        return {"pred_logits": logits, "pred_boxes": boxes}


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def grounding_param_shapes(cfg: GroundingConfig) -> dict:
    s = {}
    e = cfg.d_model
    s.update(swin_param_shapes(cfg.swin))
    s.update(bert_param_shapes(cfg.bert))
    s["feat_map.weight"] = (e, cfg.bert.hidden)
    s["feat_map.bias"] = (e,)
    chans = [cfg.swin.num_features[i] for i in cfg.swin.out_indices]
    for lv, c in enumerate(chans):
        s[f"input_proj.{lv}.0.weight"] = (e, c, 1, 1)
        s[f"input_proj.{lv}.0.bias"] = (e,)
        s[f"input_proj.{lv}.1.weight"] = (e,)
        s[f"input_proj.{lv}.1.bias"] = (e,)
    s[f"input_proj.{len(chans)}.0.weight"] = (e, chans[-1], 3, 3)
    s[f"input_proj.{len(chans)}.0.bias"] = (e,)
    s[f"input_proj.{len(chans)}.1.weight"] = (e,)
    s[f"input_proj.{len(chans)}.1.bias"] = (e,)
    s["transformer.level_embed"] = (cfg.levels, e)

    def lin(name, o, i):
        s[f"{name}.weight"] = (o, i)
        s[f"{name}.bias"] = (o,)

    def msda(name):
        n = cfg.levels * cfg.heads * cfg.n_points
        lin(f"{name}.sampling_offsets", 2 * n, e)
        lin(f"{name}.attention_weights", n, e)
        lin(f"{name}.value_proj", e, e)
        lin(f"{name}.output_proj", e, e)

    def norm(name, d=e):
        s[f"{name}.weight"] = (d,)
        s[f"{name}.bias"] = (d,)

    def mha(name):
        s[f"{name}.in_proj_weight"] = (3 * e, e)
        s[f"{name}.in_proj_bias"] = (3 * e,)
        lin(f"{name}.out_proj", e, e)

    fd = cfg.ffn // 2
    for i in range(cfg.enc_layers):
        lyr = f"transformer.encoder.layers.{i}"
        msda(f"{lyr}.self_attn")
        norm(f"{lyr}.norm1")
        lin(f"{lyr}.linear1", cfg.ffn, e)
        lin(f"{lyr}.linear2", e, cfg.ffn)
        norm(f"{lyr}.norm2")
        tl = f"transformer.encoder.text_layers.{i}"
        mha(f"{tl}.self_attn")
        lin(f"{tl}.linear1", fd, e)
        lin(f"{tl}.linear2", e, fd)
        norm(f"{tl}.norm1")
        norm(f"{tl}.norm2")
        fl = f"transformer.encoder.fusion_layers.{i}"
        norm(f"{fl}.layer_norm_v")
        norm(f"{fl}.layer_norm_l")
        for nm in ("v_proj", "l_proj", "values_v_proj", "values_l_proj"):
            lin(f"{fl}.attn.{nm}", fd, e)
        lin(f"{fl}.attn.out_v_proj", e, fd)
        lin(f"{fl}.attn.out_l_proj", e, fd)
        s[f"{fl}.gamma_v"] = (e,)
        s[f"{fl}.gamma_l"] = (e,)
    for i in range(cfg.dec_layers):
        lyr = f"transformer.decoder.layers.{i}"
        msda(f"{lyr}.cross_attn")
        norm(f"{lyr}.norm1")
        mha(f"{lyr}.ca_text")
        norm(f"{lyr}.catext_norm")
        mha(f"{lyr}.self_attn")
        norm(f"{lyr}.norm2")
        lin(f"{lyr}.linear1", cfg.ffn, e)
        lin(f"{lyr}.linear2", e, cfg.ffn)
        norm(f"{lyr}.norm3")
        for j, (o, i_) in enumerate(((e, e), (e, e), (4, e))):
            lin(f"bbox_embed.{i}.layers.{j}", o, i_)
    norm("transformer.decoder.norm")
    lin("transformer.decoder.ref_point_head.layers.0", e, 2 * e)
    lin("transformer.decoder.ref_point_head.layers.1", e, e)
    s["transformer.tgt_embed.weight"] = (cfg.num_queries, e)
    lin("transformer.enc_output", e, e)
    norm("transformer.enc_output_norm")
    for j, (o, i_) in enumerate(((e, e), (e, e), (4, e))):
        lin(f"transformer.enc_out_bbox_embed.layers.{j}", o, i_)
    return s


def init_grounding_(model: GroundingDINO,
                    generator: torch.Generator) -> GroundingDINO:
    """Random weights with the JAX package's init rules
    (init_grounding_params), drawn from `generator`."""
    def rule(name, shape, g):
        if name.endswith(".bias") or "gamma" in name:
            return torch.full(shape, 1e-4) if "gamma" in name \
                else torch.zeros(shape)
        if "norm" in name.lower() and len(shape) == 1:
            return torch.ones(shape)
        if len(shape) == 1:
            return randn(shape, 0.02, g)
        return randn(shape, fan_in(shape) ** -0.5, g)

    return init_by_rule_(model, generator, rule)


def _is_rebuilt(key: str) -> bool:
    """Checkpoint entries the model rebuilds rather than loads: the Swin
    relative-position buffers, BERT's position ids, and the decoder's
    aliases of the top-level bbox_embed heads."""
    return ("relative_position_index" in key or "relative_coords" in key
            or key.endswith("position_ids")
            or key.startswith("transformer.decoder.bbox_embed."))


def load_groundingdino_params(path: str) -> dict:
    """The official groundingdino_swint_ogc.pth -> flat numpy params with
    exactly `GroundingDINO`'s state_dict keys."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model", ckpt)
    out = {}
    for k, v in sd.items():
        k = k[len("module."):] if k.startswith("module.") else k
        if not _is_rebuilt(k):
            out[k] = np.asarray(v.float().numpy(), np.float32)
    return out


# ---------------------------------------------------------------------------
# predictor
# ---------------------------------------------------------------------------

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class GroundingDINOTorch:
    """get_grounding_output (ref:guidance/res_model.py:205-238): image +
    caption -> filtered boxes and a phrase per box, on the model's
    device."""

    def __init__(self, model: GroundingDINO, tokenizer: BertTokenizer):
        self.model = model.eval()
        self.cfg = model.cfg
        self.tokenizer = tokenizer

    @property
    def device(self) -> torch.device:
        return self.model.feat_map.weight.device

    def _prep_text(self, caption: str):
        cap = caption.lower().strip()
        if not cap.endswith("."):
            cap = cap + "."
        ids = self.tokenizer.encode(cap)
        if len(ids) > self.cfg.text_pad:
            # force a ". [SEP]" terminator so the last sub-sentence still
            # gets a bertwarper attention block and position ids:
            # special_token_masks skips a special token at the last
            # position (ref:bertwarper.py:240), so the tail's block is
            # filled by the '.' at n-2; a bare cut would leave the tail
            # diagonal-only at position 0
            ids = ids[:self.cfg.text_pad]
            ids[-2] = self.tokenizer.vocab["."]
            ids[-1] = self.tokenizer.sep_id
        n = len(ids)
        pad = self.cfg.text_pad - n
        ids_np = np.asarray(ids + [self.tokenizer.pad_id] * pad,
                            np.int32)[None]
        attn, pos, _ = special_token_masks(
            ids_np[:, :n], self.tokenizer.special_ids())
        attn_full = np.zeros((1, self.cfg.text_pad, self.cfg.text_pad),
                             bool)
        attn_full[:, :n, :n] = attn
        # padded rows attend themselves so the softmax stays finite
        for j in range(n, self.cfg.text_pad):
            attn_full[:, j, j] = True
        pos_full = np.zeros((1, self.cfg.text_pad), np.int32)
        pos_full[:, :n] = pos
        pad_mask = np.ones((1, self.cfg.text_pad), bool)
        pad_mask[:, :n] = False
        return ids_np, attn_full, pos_full, pad_mask, ids

    def inputs(self, image: np.ndarray, caption: str):
        """The model's inputs on its device, and the caption's ids."""
        s, dev = self.cfg.img_size, self.device
        img = resize_linear(torch.as_tensor(image, dtype=torch.float32,
                                            device=dev), (s, s, 3))
        img = (img - torch.as_tensor(IMAGENET_MEAN, device=dev)) \
            / torch.as_tensor(IMAGENET_STD, device=dev)
        ids_np, attn, pos, pad_mask, ids = self._prep_text(caption)
        args = [img.permute(2, 0, 1)[None]] + [
            torch.as_tensor(a, device=dev)
            for a in (ids_np, attn, pos, pad_mask)]
        return args, ids

    @torch.inference_mode()
    def predict(self, image: np.ndarray, caption: str,
                box_threshold: float = 0.3, text_threshold: float = 0.25):
        """image (H, W, 3) float [0,1] -> (boxes (n, 4) cxcywh
        normalized, scores (n,), phrases list[str])."""
        args, ids = self.inputs(image, caption)
        out = self.model(*args)
        raw = out["pred_logits"][0].float().cpu().numpy()
        with np.errstate(over="ignore"):
            logits = 1.0 / (1.0 + np.exp(-raw))  # -inf pad -> 0
        boxes = out["pred_boxes"][0].float().cpu().numpy()
        scores = logits.max(-1)
        keep = scores > box_threshold
        phrases: List[str] = []
        for row in logits[keep]:
            posmap = row[:len(ids)] > text_threshold
            tok = [ids[i] for i in np.nonzero(posmap)[0]]
            phrases.append(self.tokenizer.decode(tok))
        return boxes[keep], scores[keep].astype(np.float32), phrases
