"""Segment-Anything (SAM), box-prompted mask prediction.

Counterpart of goi_tpu/query/sam.py: the vendored torch SAM
(ref:ext/segment_anything/modeling/{image_encoder,prompt_encoder,
mask_decoder,transformer,sam}.py, build configs build_sam.py:14-56).
`SAM`'s state_dict keys are the official checkpoint's names
(``image_encoder.blocks.0.attn.qkv.weight`` ...), so `load_sam_params`
is a torch.load and a float cast.

The RES pipeline (query/res.py) uses the box-prompted single-mask path
(ref:guidance/res_model.py:285-340): `SamTorch` is SamPredictor's
set_image + predict_torch(boxes=..., multimask_output=False), with the
longest-side-1024 resize, mean/std normalization, bottom-right padding
and the 256 -> 1024 -> crop -> original upscale chain
(ref:ext/segment_anything/predictor.py, modeling/sam.py:139-172), each
resize with jax.image.resize's bilinear semantics
(utils/image.py `resize_linear`), as the JAX package resizes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from goi_tpu_torch.query._nn import (MLP, fan_in, gelu, init_by_rule_,
                                     layer_norm, linear, merge_heads, randn,
                                     split_heads)
from goi_tpu_torch.utils.image import resize_linear
from goi_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class SAMConfig:
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    global_attn: Tuple[int, ...] = (2, 5, 8, 11)
    window: int = 14
    img_size: int = 1024
    patch: int = 16
    prompt_dim: int = 256
    mask_in_chans: int = 16
    decoder_depth: int = 2
    decoder_heads: int = 8
    decoder_mlp: int = 2048
    num_multimask: int = 3

    @property
    def grid(self) -> int:
        return self.img_size // self.patch


# checkpoint configs (ref:build_sam.py:14-44)
SAM_VIT_B = SAMConfig()
SAM_VIT_L = SAMConfig(embed_dim=1024, depth=24, num_heads=16,
                      global_attn=(5, 11, 17, 23))
SAM_VIT_H = SAMConfig(embed_dim=1280, depth=32, num_heads=16,
                      global_attn=(7, 15, 23, 31))

PIXEL_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
PIXEL_STD = np.array([58.395, 57.12, 57.375], np.float32)
EPS = 1e-6            # SAM's image-encoder and LayerNorm2d eps
EPS_DECODER = 1e-5    # the two-way transformer's nn.LayerNorm default


class LayerNorm2d(nn.Module):
    """LayerNorm over the channel dim of NCHW (ref:modeling/common.py:
    31-43)."""

    def __init__(self, c: int, device, eps: float = EPS):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m = x.mean(1, keepdim=True)
        v = ((x - m) ** 2).mean(1, keepdim=True)
        x = (x - m) / torch.sqrt(v + self.eps)
        return x * self.weight[None, :, None, None] \
            + self.bias[None, :, None, None]


def _lin12(d_in: int, hid: int, d_out: int, device) -> nn.ModuleDict:
    """MLPBlock's lin1 / lin2 (ref:modeling/common.py:13-28)."""
    return nn.ModuleDict({"lin1": linear(d_in, hid, device=device),
                          "lin2": linear(hid, d_out, device=device)})


# ---------------------------------------------------------------------------
# image encoder (ViTDet; ref:modeling/image_encoder.py)
# ---------------------------------------------------------------------------

def _get_rel_pos(q_size: int, k_size: int,
                 rel_pos: torch.Tensor) -> torch.Tensor:
    """(2*max(q,k)-1, d) table -> (q, k, d) lookup, linearly resizing the
    table when the sizes differ (ref:image_encoder.py:292-322)."""
    max_rel = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != max_rel:
        rel_pos = resize_linear(rel_pos, (max_rel, rel_pos.shape[1]))
    q = np.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k = np.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    rel = (q - k) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[torch.as_tensor(rel.astype(np.int64),
                                   device=rel_pos.device)]


class ViTAttention(nn.Module):
    """Windowed or global ViT attention with decomposed relative
    position (ref:image_encoder.py:185-245, add_decomposed_rel_pos
    :325-373)."""

    def __init__(self, dim: int, heads: int, rel_size: int, device):
        super().__init__()
        self.heads = heads
        hd = dim // heads
        self.qkv = linear(dim, 3 * dim, device=device)
        self.proj = linear(dim, dim, device=device)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * rel_size - 1, hd,
                                                  device=device))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * rel_size - 1, hd,
                                                  device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, C)."""
        b, h, w, c = x.shape
        nh, hd = self.heads, c // self.heads
        qkv = self.qkv(x).reshape(b, h * w, 3, nh, hd).permute(2, 0, 3, 1, 4) \
            .reshape(3, b * nh, h * w, hd)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = (q * hd ** -0.5) @ k.transpose(-1, -2)
        rh = _get_rel_pos(h, h, self.rel_pos_h)
        rw = _get_rel_pos(w, w, self.rel_pos_w)
        rq = q.reshape(b * nh, h, w, hd)
        rel_h = torch.einsum("bhwc,hkc->bhwk", rq, rh)
        rel_w = torch.einsum("bhwc,wkc->bhwk", rq, rw)
        attn = (attn.reshape(b * nh, h, w, h, w) + rel_h[:, :, :, :, None]
                + rel_w[:, :, :, None, :]).reshape(b * nh, h * w, h * w)
        out = (torch.softmax(attn, -1) @ v).reshape(b, nh, h, w, hd) \
            .permute(0, 2, 3, 1, 4).reshape(b, h, w, c)
        return self.proj(out)


def _window_partition(x: torch.Tensor, ws: int):
    b, h, w, c = x.shape
    ph, pw = (-h) % ws, (-w) % ws
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.reshape(b, hp // ws, ws, wp // ws, ws, c)
    return (x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c), (hp, wp))


def _window_unpartition(win: torch.Tensor, ws: int, pad_hw, hw):
    hp, wp = pad_hw
    h, w = hw
    b = win.shape[0] // (hp * wp // ws // ws)
    x = win.reshape(b, hp // ws, wp // ws, ws, ws, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w]


class ViTBlock(nn.Module):
    def __init__(self, cfg: SAMConfig, window: int, device):
        super().__init__()
        e = cfg.embed_dim
        self.window = window      # 0: global attention over the grid
        self.norm1 = layer_norm(e, eps=EPS, device=device)
        self.attn = ViTAttention(e, cfg.num_heads, window or cfg.grid,
                                 device)
        self.norm2 = layer_norm(e, eps=EPS, device=device)
        self.mlp = _lin12(e, 4 * e, e, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm1(x)
        if self.window:
            h, w = y.shape[1], y.shape[2]
            win, pad_hw = _window_partition(y, self.window)
            y = _window_unpartition(self.attn(win), self.window, pad_hw,
                                    (h, w))
        else:
            y = self.attn(y)
        x = x + y
        return x + self.mlp["lin2"](gelu(self.mlp["lin1"](self.norm2(x))))


class ImageEncoder(nn.Module):
    """(B, 3, 1024, 1024) normalized image -> (B, 256, 64, 64) embedding
    (ref:image_encoder.py:107-117)."""

    def __init__(self, cfg: SAMConfig, device):
        super().__init__()
        e, pd = cfg.embed_dim, cfg.prompt_dim
        self.patch_embed = nn.ModuleDict({"proj": nn.Conv2d(
            3, e, cfg.patch, stride=cfg.patch, device=device)})
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.grid, cfg.grid, e,
                                                  device=device))
        self.blocks = nn.ModuleList(
            ViTBlock(cfg, 0 if i in cfg.global_attn else cfg.window, device)
            for i in range(cfg.depth))
        self.neck = nn.Sequential(
            nn.Conv2d(e, pd, 1, bias=False, device=device),
            LayerNorm2d(pd, device),
            nn.Conv2d(pd, pd, 3, padding=1, bias=False, device=device),
            LayerNorm2d(pd, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed["proj"](x).permute(0, 2, 3, 1) + self.pos_embed
        for blk in self.blocks:
            x = blk(x)
        return self.neck(x.permute(0, 3, 1, 2))


# ---------------------------------------------------------------------------
# prompt encoder (ref:modeling/prompt_encoder.py)
# ---------------------------------------------------------------------------

class PromptEncoder(nn.Module):
    def __init__(self, cfg: SAMConfig, device):
        super().__init__()
        self.cfg = cfg
        pd, mc = cfg.prompt_dim, cfg.mask_in_chans
        self.pe_layer = nn.Module()
        self.pe_layer.positional_encoding_gaussian_matrix = nn.Parameter(
            torch.zeros(2, pd // 2, device=device))
        self.point_embeddings = nn.ModuleList(
            nn.Embedding(1, pd, device=device) for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, pd, device=device)
        self.no_mask_embed = nn.Embedding(1, pd, device=device)
        # the mask prompt's path: unused by the box path, kept for the
        # checkpoint's keys
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, mc // 4, 2, stride=2, device=device),
            LayerNorm2d(mc // 4, device), nn.GELU(),
            nn.Conv2d(mc // 4, mc, 2, stride=2, device=device),
            LayerNorm2d(mc, device), nn.GELU(),
            nn.Conv2d(mc, pd, 1, device=device))

    def pe_encode(self, coords: torch.Tensor) -> torch.Tensor:
        """[0,1] coords (..., 2) -> (..., prompt_dim) random-Fourier PE
        (ref:prompt_encoder.py:183-195)."""
        g = self.pe_layer.positional_encoding_gaussian_matrix
        c = (2.0 * coords - 1.0) @ g * (2.0 * np.pi)
        return torch.cat([torch.sin(c), torch.cos(c)], -1)

    def dense_pe(self) -> torch.Tensor:
        """(1, prompt_dim, grid, grid) grid PE (get_dense_pe)."""
        gs = self.cfg.grid
        y = (np.arange(gs, dtype=np.float32) + 0.5) / gs
        x = (np.arange(gs, dtype=np.float32) + 0.5) / gs
        grid = np.stack(np.meshgrid(x, y, indexing="xy"), -1)
        dev = self.no_mask_embed.weight.device
        return self.pe_encode(torch.as_tensor(grid, device=dev)) \
            .permute(2, 0, 1)[None]

    def encode_boxes(self, boxes: torch.Tensor) -> torch.Tensor:
        """(B, 4) xyxy in 1024-input pixels -> (B, 2, prompt_dim) sparse
        embedding (ref:prompt_encoder.py:96-104)."""
        coords = (boxes.reshape(-1, 2, 2) + 0.5) / self.cfg.img_size
        corner = torch.stack([self.point_embeddings[2].weight[0],
                              self.point_embeddings[3].weight[0]])
        return self.pe_encode(coords) + corner[None]

    def encode_points(self, points: torch.Tensor, labels: torch.Tensor,
                      pad: bool = True) -> torch.Tensor:
        """(B, N, 2) pixel coords + (B, N) labels {1 pos, 0 neg, -1 pad}
        -> (B, N(+1), prompt_dim) (ref:prompt_encoder.py:75-94)."""
        if pad:
            points = torch.cat([points, torch.zeros_like(points[:, :1])], 1)
            labels = torch.cat([labels, -torch.ones_like(labels[:, :1])], 1)
        emb = self.pe_encode((points + 0.5) / self.cfg.img_size)
        lab = labels[..., None]
        emb = torch.where(lab == -1, self.not_a_point_embed.weight[0], emb)
        emb = torch.where(lab == 0, emb + self.point_embeddings[0].weight[0],
                          emb)
        return torch.where(lab == 1,
                           emb + self.point_embeddings[1].weight[0], emb)

    def no_mask(self, bs: int) -> torch.Tensor:
        """(bs, prompt_dim, grid, grid) dense embedding when no mask
        prompt."""
        e = self.no_mask_embed.weight[0]
        g = self.cfg.grid
        return e[None, :, None, None].expand(bs, e.shape[0], g, g)


# ---------------------------------------------------------------------------
# two-way transformer + mask decoder (ref:modeling/transformer.py,
# mask_decoder.py)
# ---------------------------------------------------------------------------

class DecAttention(nn.Module):
    """Attention with an optional channel downsample
    (ref:transformer.py:185-240)."""

    def __init__(self, dim: int, inner: int, heads: int, device):
        super().__init__()
        self.heads = heads
        self.q_proj = linear(dim, inner, device=device)
        self.k_proj = linear(dim, inner, device=device)
        self.v_proj = linear(dim, inner, device=device)
        self.out_proj = linear(inner, dim, device=device)

    def forward(self, q, k, v):
        qh = split_heads(self.q_proj(q), self.heads)
        kh = split_heads(self.k_proj(k), self.heads)
        vh = split_heads(self.v_proj(v), self.heads)
        a = torch.softmax(qh @ kh.transpose(-1, -2)
                          / math.sqrt(qh.shape[-1]), -1)
        return self.out_proj(merge_heads(a @ vh))


class TwoWayLayer(nn.Module):
    def __init__(self, cfg: SAMConfig, device):
        super().__init__()
        pd, nh = cfg.prompt_dim, cfg.decoder_heads
        self.self_attn = DecAttention(pd, pd, nh, device)
        self.cross_attn_token_to_image = DecAttention(pd, pd // 2, nh, device)
        self.cross_attn_image_to_token = DecAttention(pd, pd // 2, nh, device)
        self.mlp = _lin12(pd, cfg.decoder_mlp, pd, device)
        for j in range(1, 5):
            self.add_module(f"norm{j}", layer_norm(pd, eps=EPS_DECODER,
                                                   device=device))


class TwoWayTransformer(nn.Module):
    def __init__(self, cfg: SAMConfig, device):
        super().__init__()
        pd = cfg.prompt_dim
        self.layers = nn.ModuleList(TwoWayLayer(cfg, device)
                                    for _ in range(cfg.decoder_depth))
        self.final_attn_token_to_image = DecAttention(
            pd, pd // 2, cfg.decoder_heads, device)
        self.norm_final_attn = layer_norm(pd, eps=EPS_DECODER, device=device)

    def forward(self, image_emb, image_pe, tokens):
        """(B, C, H, W) image emb + PE, (B, T, C) query tokens ->
        (queries (B,T,C), keys (B,HW,C)) (ref:transformer.py:62-106)."""
        b, c, h, w = image_emb.shape
        keys = image_emb.reshape(b, c, h * w).transpose(1, 2)
        key_pe = image_pe.reshape(image_pe.shape[0], c, h * w).transpose(1, 2)
        queries = tokens
        for i, lyr in enumerate(self.layers):
            if i == 0:
                # skip_first_layer_pe: self-attn replaces the queries
                # (ref:transformer.py:158-162)
                queries = lyr.self_attn(queries, queries, queries)
            else:
                q = queries + tokens
                queries = queries + lyr.self_attn(q, q, queries)
            queries = lyr.norm1(queries)
            q, k = queries + tokens, keys + key_pe
            queries = lyr.norm2(queries + lyr.cross_attn_token_to_image(
                q, k, keys))
            queries = lyr.norm3(queries + lyr.mlp["lin2"](
                F.relu(lyr.mlp["lin1"](queries))))
            q, k = queries + tokens, keys + key_pe
            keys = lyr.norm4(keys + lyr.cross_attn_image_to_token(
                k, q, queries))
        q, k = queries + tokens, keys + key_pe
        queries = self.norm_final_attn(
            queries + self.final_attn_token_to_image(q, k, keys))
        return queries, keys


class MaskDecoder(nn.Module):
    def __init__(self, cfg: SAMConfig, device):
        super().__init__()
        pd = cfg.prompt_dim
        nm = cfg.num_multimask + 1
        self.iou_token = nn.Embedding(1, pd, device=device)
        self.mask_tokens = nn.Embedding(nm, pd, device=device)
        self.transformer = TwoWayTransformer(cfg, device)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(pd, pd // 4, 2, stride=2, device=device),
            LayerNorm2d(pd // 4, device), nn.GELU(),
            nn.ConvTranspose2d(pd // 4, pd // 8, 2, stride=2, device=device),
            nn.GELU())
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLP((pd, pd, pd, pd // 8), device) for _ in range(nm))
        self.iou_prediction_head = MLP((pd, 256, 256, nm), device)

    def forward(self, image_emb, image_pe, sparse, dense, multimask: bool):
        """-> (masks (B, n, 256, 256) logits, iou_pred (B, n))
        (ref:mask_decoder.py:91-176). n = 3 if multimask else 1."""
        nm = self.mask_tokens.weight.shape[0]
        out_tok = torch.cat([self.iou_token.weight,
                             self.mask_tokens.weight], 0)
        b = sparse.shape[0]
        tokens = torch.cat([out_tok[None].expand(b, -1, -1), sparse], 1)
        src = image_emb + dense
        hs, keys = self.transformer(src, image_pe.expand_as(src), tokens)
        c, h, w = src.shape[1:]
        up = self.output_upscaling(keys.transpose(1, 2).reshape(b, c, h, w))
        hyper = torch.stack([mlp(hs[:, 1 + i]) for i, mlp in
                             enumerate(self.output_hypernetworks_mlps)], 1)
        hh, ww = up.shape[2:]
        masks = (hyper @ up.reshape(b, up.shape[1], hh * ww)) \
            .reshape(b, nm, hh, ww)
        iou = self.iou_prediction_head(hs[:, 0])
        sl = slice(1, None) if multimask else slice(0, 1)
        return masks[:, sl], iou[:, sl]


class SAM(nn.Module):
    """Segment-Anything's image encoder, prompt encoder and mask decoder
    under the checkpoint's names."""

    def __init__(self, cfg: SAMConfig = SAM_VIT_H, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.image_encoder = ImageEncoder(cfg, device)
        self.prompt_encoder = PromptEncoder(cfg, device)
        self.mask_decoder = MaskDecoder(cfg, device)


# ---------------------------------------------------------------------------
# predictor (resize / normalize / postprocess; ref:predictor.py, sam.py)
# ---------------------------------------------------------------------------

class SamTorch:
    """SamPredictor for the box-prompted path, on the model's device."""

    def __init__(self, model: SAM):
        self.model = model.eval()
        self.cfg = model.cfg
        self._emb: Optional[torch.Tensor] = None
        self._orig_hw = None
        self._new_hw = None

    @property
    def device(self) -> torch.device:
        return self.model.image_encoder.pos_embed.device

    @staticmethod
    def _longest_side(h, w, target):
        scale = target / max(h, w)
        return int(h * scale + 0.5), int(w * scale + 0.5)

    @torch.inference_mode()
    def set_image(self, image: np.ndarray) -> None:
        """image: (H, W, 3) uint8/float RGB (ref:predictor.py set_image:
        resize the longest side to 1024, normalize, pad bottom-right)."""
        cfg, dev = self.cfg, self.device
        h, w = image.shape[:2]
        nh, nw = self._longest_side(h, w, cfg.img_size)
        with span("sam.encoder"):
            img = resize_linear(torch.as_tensor(np.asarray(image, np.float32),
                                                device=dev), (nh, nw, 3))
            img = (img - torch.as_tensor(PIXEL_MEAN, device=dev)) \
                / torch.as_tensor(PIXEL_STD, device=dev)
            img = F.pad(img, (0, 0, 0, cfg.img_size - nw,
                              0, cfg.img_size - nh))
            self._emb = self.model.image_encoder(img.permute(2, 0, 1)[None])
        self._orig_hw = (h, w)
        self._new_hw = (nh, nw)

    @torch.inference_mode()
    def predict_boxes(self, boxes: np.ndarray, multimask: bool = False):
        """boxes: (B, 4) xyxy in original image pixels -> (masks
        (B, n, H, W) bool, iou (B, n)) as numpy: predict_torch(boxes=...,
        multimask_output=...) (ref:guidance/res_model.py:296-306)."""
        if self._emb is None:
            raise RuntimeError("call set_image() first")
        cfg, m, dev = self.cfg, self.model, self._emb.device
        h, w = self._orig_hw
        nh, nw = self._new_hw
        with span("sam.decode"):
            scale = torch.tensor([nw / w, nh / h, nw / w, nh / h],
                                 dtype=torch.float32, device=dev)
            pe = m.prompt_encoder
            sparse = pe.encode_boxes(torch.as_tensor(
                np.asarray(boxes, np.float32), device=dev) * scale)
            b = sparse.shape[0]
            masks, iou = m.mask_decoder(
                self._emb.expand(b, -1, -1, -1), pe.dense_pe(), sparse,
                pe.no_mask(b), multimask)
            # postprocess_masks: 256 -> 1024, crop the padding, ->
            # original
            n = masks.shape[1]
            up = resize_linear(masks, (b, n, cfg.img_size, cfg.img_size))
            up = resize_linear(up[:, :, :nh, :nw], (b, n, h, w))
            return (up > 0.0).cpu().numpy(), iou.float().cpu().numpy()


# ---------------------------------------------------------------------------
# params: shapes, random init, checkpoint load
# ---------------------------------------------------------------------------

def sam_param_shapes(cfg: SAMConfig) -> dict:
    """Every checkpoint key -> shape (validated against the official
    sam_vit_* state_dicts)."""
    s = {}
    e, pd = cfg.embed_dim, cfg.prompt_dim

    def lin(name, o, i):
        s[f"{name}.weight"] = (o, i)
        s[f"{name}.bias"] = (o,)

    s["image_encoder.patch_embed.proj.weight"] = (e, 3, cfg.patch,
                                                  cfg.patch)
    s["image_encoder.patch_embed.proj.bias"] = (e,)
    s["image_encoder.pos_embed"] = (1, cfg.grid, cfg.grid, e)
    for i in range(cfg.depth):
        blk = f"image_encoder.blocks.{i}"
        ws = cfg.grid if i in cfg.global_attn else cfg.window
        s[f"{blk}.norm1.weight"] = (e,)
        s[f"{blk}.norm1.bias"] = (e,)
        s[f"{blk}.attn.qkv.weight"] = (3 * e, e)
        s[f"{blk}.attn.qkv.bias"] = (3 * e,)
        lin(f"{blk}.attn.proj", e, e)
        s[f"{blk}.attn.rel_pos_h"] = (2 * ws - 1, e // cfg.num_heads)
        s[f"{blk}.attn.rel_pos_w"] = (2 * ws - 1, e // cfg.num_heads)
        s[f"{blk}.norm2.weight"] = (e,)
        s[f"{blk}.norm2.bias"] = (e,)
        lin(f"{blk}.mlp.lin1", 4 * e, e)
        lin(f"{blk}.mlp.lin2", e, 4 * e)
    s["image_encoder.neck.0.weight"] = (pd, e, 1, 1)
    s["image_encoder.neck.1.weight"] = (pd,)
    s["image_encoder.neck.1.bias"] = (pd,)
    s["image_encoder.neck.2.weight"] = (pd, pd, 3, 3)
    s["image_encoder.neck.3.weight"] = (pd,)
    s["image_encoder.neck.3.bias"] = (pd,)

    s["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"] = \
        (2, pd // 2)
    for i in range(4):
        s[f"prompt_encoder.point_embeddings.{i}.weight"] = (1, pd)
    s["prompt_encoder.not_a_point_embed.weight"] = (1, pd)
    s["prompt_encoder.no_mask_embed.weight"] = (1, pd)
    mc = cfg.mask_in_chans
    s["prompt_encoder.mask_downscaling.0.weight"] = (mc // 4, 1, 2, 2)
    s["prompt_encoder.mask_downscaling.0.bias"] = (mc // 4,)
    s["prompt_encoder.mask_downscaling.1.weight"] = (mc // 4,)
    s["prompt_encoder.mask_downscaling.1.bias"] = (mc // 4,)
    s["prompt_encoder.mask_downscaling.3.weight"] = (mc, mc // 4, 2, 2)
    s["prompt_encoder.mask_downscaling.3.bias"] = (mc,)
    s["prompt_encoder.mask_downscaling.4.weight"] = (mc,)
    s["prompt_encoder.mask_downscaling.4.bias"] = (mc,)
    s["prompt_encoder.mask_downscaling.6.weight"] = (pd, mc, 1, 1)
    s["prompt_encoder.mask_downscaling.6.bias"] = (pd,)

    pre = "mask_decoder"
    nm = cfg.num_multimask + 1
    s[f"{pre}.iou_token.weight"] = (1, pd)
    s[f"{pre}.mask_tokens.weight"] = (nm, pd)
    for i in range(cfg.decoder_depth):
        lyr = f"{pre}.transformer.layers.{i}"
        for at, dim in (("self_attn", pd),
                        ("cross_attn_token_to_image", pd // 2),
                        ("cross_attn_image_to_token", pd // 2)):
            for nm_ in ("q_proj", "k_proj", "v_proj"):
                lin(f"{lyr}.{at}.{nm_}", dim, pd)
            lin(f"{lyr}.{at}.out_proj", pd, dim)
        for j in range(1, 5):
            s[f"{lyr}.norm{j}.weight"] = (pd,)
            s[f"{lyr}.norm{j}.bias"] = (pd,)
        lin(f"{lyr}.mlp.lin1", cfg.decoder_mlp, pd)
        lin(f"{lyr}.mlp.lin2", pd, cfg.decoder_mlp)
    for nm_ in ("q_proj", "k_proj", "v_proj"):
        lin(f"{pre}.transformer.final_attn_token_to_image.{nm_}",
            pd // 2, pd)
    lin(f"{pre}.transformer.final_attn_token_to_image.out_proj",
        pd, pd // 2)
    s[f"{pre}.transformer.norm_final_attn.weight"] = (pd,)
    s[f"{pre}.transformer.norm_final_attn.bias"] = (pd,)
    s[f"{pre}.output_upscaling.0.weight"] = (pd, pd // 4, 2, 2)
    s[f"{pre}.output_upscaling.0.bias"] = (pd // 4,)
    s[f"{pre}.output_upscaling.1.weight"] = (pd // 4,)
    s[f"{pre}.output_upscaling.1.bias"] = (pd // 4,)
    s[f"{pre}.output_upscaling.3.weight"] = (pd // 4, pd // 8, 2, 2)
    s[f"{pre}.output_upscaling.3.bias"] = (pd // 8,)
    for i in range(nm):
        h = f"{pre}.output_hypernetworks_mlps.{i}"
        lin(f"{h}.layers.0", pd, pd)
        lin(f"{h}.layers.1", pd, pd)
        lin(f"{h}.layers.2", pd // 8, pd)
    h = f"{pre}.iou_prediction_head"
    lin(f"{h}.layers.0", 256, pd)
    lin(f"{h}.layers.1", 256, 256)
    lin(f"{h}.layers.2", nm, 256)
    return s


def init_sam_(model: SAM, generator: torch.Generator) -> SAM:
    """Random weights with the JAX package's init rules
    (init_sam_params), drawn from `generator`."""
    def rule(name, shape, g):
        if name.endswith(".bias") or "norm" in name or ".neck.1" in name \
                or ".neck.3" in name:
            return torch.zeros(shape) if name.endswith("bias") \
                else torch.ones(shape)
        if name.endswith("pos_embed") or "rel_pos" in name:
            return randn(shape, 0.02, g)
        return randn(shape, fan_in(shape) ** -0.5, g)

    return init_by_rule_(model, generator, rule)


def load_sam_params(path: str) -> dict:
    """An official sam_vit_*.pth checkpoint -> flat numpy params."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: np.asarray(v.float().numpy(), np.float32)
            for k, v in sd.items()}
