"""Swin Transformer backbone (detection variant).

Counterpart of goi_tpu/query/swin.py: GroundingDINO's vendored Swin
(ref:ext/GroundingDINO/groundingdino/models/GroundingDINO/backbone/
swin_transformer.py), the image tower of the RES detector.
`SwinBackbone`'s state_dict keys are the official checkpoint's names
under ``backbone.0.`` (``layers.0.blocks.0.attn.qkv.weight`` ...), so
the released groundingdino_swint_ogc.pth loads without renaming. The
relative-position index is a non-persistent buffer and the
shifted-window masks are built for each padded input size: the
checkpoint carries neither.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from goi_tpu_torch.query._nn import gelu, layer_norm, linear


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window: int = 7
    out_indices: Tuple[int, ...] = (1, 2, 3)
    mlp_ratio: float = 4.0

    @property
    def num_features(self) -> Tuple[int, ...]:
        return tuple(int(self.embed_dim * 2 ** i)
                     for i in range(len(self.depths)))


# checkpoint configs (ref:swin_transformer.py:771-787)
SWIN_T = SwinConfig()
SWIN_B = SwinConfig(embed_dim=128, depths=(2, 2, 18, 2),
                    num_heads=(4, 8, 16, 32))
SWIN_TINY_TEST = SwinConfig(embed_dim=8, depths=(2, 2), num_heads=(2, 2),
                            window=4, out_indices=(0, 1))
EPS = 1e-5   # torch nn.LayerNorm's default


def _rel_pos_index(ws: int) -> np.ndarray:
    """(ws*ws, ws*ws) int index into the (2ws-1)^2 bias table
    (ref:swin_transformer.py:114-124)."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij"))          # 2, ws, ws
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]              # 2, n, n
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


@lru_cache(maxsize=16)
def _shift_attn_mask(hp: int, wp: int, ws: int, shift: int) -> np.ndarray:
    """(num_windows, ws*ws, ws*ws) additive mask (0 / -100) for the
    shifted windows (ref:swin_transformer.py:370-392)."""
    img = np.zeros((hp, wp), np.int32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for vs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, vs] = cnt
            cnt += 1
    win = img.reshape(hp // ws, ws, wp // ws, ws) \
        .transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    mask = win[:, None, :] - win[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    """(ref:swin_transformer.py:133-166)."""

    def __init__(self, dim: int, heads: int, ws: int, device):
        super().__init__()
        self.heads = heads
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * ws - 1) ** 2, heads, device=device))
        self.register_buffer(
            "relative_position_index",
            torch.as_tensor(_rel_pos_index(ws).reshape(-1), device=device),
            persistent=False)
        self.qkv = linear(dim, 3 * dim, device=device)
        self.proj = linear(dim, dim, device=device)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None):
        """x: (B*nW, ws*ws, C); mask (nW, n, n) or None."""
        bn, n, c = x.shape
        hd = c // self.heads
        qkv = self.qkv(x).reshape(bn, n, 3, self.heads, hd) \
            .permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = (q * hd ** -0.5) @ k.transpose(-1, -2)      # (bn, h, n, n)
        bias = self.relative_position_bias_table[
            self.relative_position_index].reshape(n, n, self.heads)
        attn = attn + bias.permute(2, 0, 1)[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.reshape(bn // nw, nw, self.heads, n, n) \
                + mask[None, :, None]
            attn = attn.reshape(bn, self.heads, n, n)
        out = (torch.softmax(attn, -1) @ v).transpose(1, 2).reshape(bn, n, c)
        return self.proj(out)


class SwinBlock(nn.Module):
    """One SwinTransformerBlock on (B, H*W, C)
    (ref:swin_transformer.py:225-291)."""

    def __init__(self, dim: int, heads: int, ws: int, shift: int,
                 mlp_ratio: float, device):
        super().__init__()
        self.ws, self.shift = ws, shift
        self.norm1 = layer_norm(dim, eps=EPS, device=device)
        self.attn = WindowAttention(dim, heads, ws, device)
        self.norm2 = layer_norm(dim, eps=EPS, device=device)
        hid = int(dim * mlp_ratio)
        self.mlp = nn.ModuleDict({"fc1": linear(dim, hid, device=device),
                                  "fc2": linear(hid, dim, device=device)})

    def forward(self, x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        h, w = hw
        b, _, c = x.shape
        ws, shift = self.ws, self.shift
        shortcut = x
        x = self.norm1(x).reshape(b, h, w, c)
        ph, pw = (-h) % ws, (-w) % ws
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
        hp, wp = h + ph, w + pw
        mask = None
        if shift:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
            mask = torch.as_tensor(_shift_attn_mask(hp, wp, ws, shift),
                                   device=x.device)
        win = x.reshape(b, hp // ws, ws, wp // ws, ws, c) \
            .permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)
        win = self.attn(win, mask)
        x = win.reshape(b, hp // ws, wp // ws, ws, ws, c) \
            .permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)
        if shift:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        x = shortcut + x[:, :h, :w].reshape(b, h * w, c)
        y = self.mlp["fc2"](gelu(self.mlp["fc1"](self.norm2(x))))
        return x + y


class PatchMerging(nn.Module):
    """(B, H*W, C) -> (B, ceil(H/2)*ceil(W/2), 2C)
    (ref:swin_transformer.py:300-338)."""

    def __init__(self, dim: int, device):
        super().__init__()
        self.norm = layer_norm(4 * dim, eps=EPS, device=device)
        self.reduction = linear(4 * dim, 2 * dim, bias=False, device=device)

    def forward(self, x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        h, w = hw
        b, _, c = x.shape
        x = F.pad(x.reshape(b, h, w, c), (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
        return self.reduction(self.norm(x.reshape(b, -1, 4 * c)))


class SwinBackbone(nn.Module):
    """(B, 3, H, W) image -> [(B, C_i, H_i, W_i) for out_indices]
    (ref:swin_transformer.py:711-746; goi_tpu's swin_forward)."""

    def __init__(self, cfg: SwinConfig = SWIN_T, device="cuda"):
        super().__init__()
        self.cfg = cfg
        e = cfg.embed_dim
        self.patch_embed = nn.ModuleDict({
            "proj": nn.Conv2d(3, e, 4, stride=4, device=device),
            "norm": layer_norm(e, eps=EPS, device=device)})
        self.layers = nn.ModuleList()
        for i, depth in enumerate(cfg.depths):
            c = cfg.num_features[i]
            stage = nn.Module()
            stage.blocks = nn.ModuleList(
                SwinBlock(c, cfg.num_heads[i], cfg.window,
                          0 if j % 2 == 0 else cfg.window // 2,
                          cfg.mlp_ratio, device) for j in range(depth))
            if i < len(cfg.depths) - 1:
                stage.downsample = PatchMerging(c, device)
            self.layers.append(stage)
        for i in cfg.out_indices:
            self.add_module(f"norm{i}", layer_norm(cfg.num_features[i],
                                                   eps=EPS, device=device))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        cfg = self.cfg
        b = x.shape[0]
        x = F.pad(x, (0, (-x.shape[3]) % 4, 0, (-x.shape[2]) % 4))
        x = self.patch_embed["proj"](x)
        h, w = x.shape[2], x.shape[3]
        x = self.patch_embed["norm"](x.reshape(b, cfg.embed_dim, h * w)
                                     .transpose(1, 2))
        outs = []
        for i, stage in enumerate(self.layers):
            for blk in stage.blocks:
                x = blk(x, (h, w))
            if i in cfg.out_indices:
                y = getattr(self, f"norm{i}")(x)
                outs.append(y.transpose(1, 2)
                            .reshape(b, cfg.num_features[i], h, w))
            if i < len(self.layers) - 1:
                x = stage.downsample(x, (h, w))
                h, w = (h + 1) // 2, (w + 1) // 2
        return outs


def swin_param_shapes(cfg: SwinConfig,
                      prefix: str = "backbone.0") -> dict:
    s = {}
    e = cfg.embed_dim
    s[f"{prefix}.patch_embed.proj.weight"] = (e, 3, 4, 4)
    s[f"{prefix}.patch_embed.proj.bias"] = (e,)
    s[f"{prefix}.patch_embed.norm.weight"] = (e,)
    s[f"{prefix}.patch_embed.norm.bias"] = (e,)
    ws = cfg.window
    for i, depth in enumerate(cfg.depths):
        c = cfg.num_features[i]
        for j in range(depth):
            blk = f"{prefix}.layers.{i}.blocks.{j}"
            for nm in ("norm1", "norm2"):
                s[f"{blk}.{nm}.weight"] = (c,)
                s[f"{blk}.{nm}.bias"] = (c,)
            s[f"{blk}.attn.relative_position_bias_table"] = \
                ((2 * ws - 1) ** 2, cfg.num_heads[i])
            s[f"{blk}.attn.qkv.weight"] = (3 * c, c)
            s[f"{blk}.attn.qkv.bias"] = (3 * c,)
            s[f"{blk}.attn.proj.weight"] = (c, c)
            s[f"{blk}.attn.proj.bias"] = (c,)
            hid = int(c * cfg.mlp_ratio)
            s[f"{blk}.mlp.fc1.weight"] = (hid, c)
            s[f"{blk}.mlp.fc1.bias"] = (hid,)
            s[f"{blk}.mlp.fc2.weight"] = (c, hid)
            s[f"{blk}.mlp.fc2.bias"] = (c,)
        if i < len(cfg.depths) - 1:
            dn = f"{prefix}.layers.{i}.downsample"
            s[f"{dn}.norm.weight"] = (4 * c,)
            s[f"{dn}.norm.bias"] = (4 * c,)
            s[f"{dn}.reduction.weight"] = (2 * c, 4 * c)
    for i in cfg.out_indices:
        c = cfg.num_features[i]
        s[f"{prefix}.norm{i}.weight"] = (c,)
        s[f"{prefix}.norm{i}.bias"] = (c,)
    return s
