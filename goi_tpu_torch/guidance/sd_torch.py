"""Stable-Diffusion backend in PyTorch: the SD-1.x UNet and VAE.

Counterpart of goi_tpu/guidance/sd_jax.py. The reference drives its SDS
editing loops with diffusers' StableDiffusionInpaintPipeline
(ref:guidance/sd_inpainting_utils.py:60-123: vae.encode, unet(latent_in,
t, text_emb), DDIM alphas). Here the architecture is a tree of
``nn.Module``s whose ``state_dict()`` keys are the diffusers names, so a
diffusers UNet2DConditionModel / AutoencoderKL state dict loads straight
into `UNet2DCondition` / `AutoencoderKL`, and the JAX package's flat
params dict loads through `interop.sd_from_numpy`.

  - `TorchDiffusionBackend` satisfies guidance/sds.py's DiffusionBackend
    protocol: `alphas` (cumprod schedule), `encode_images`, `unet_eps`,
    and `decode_latents`.
  - `SDConfig` defaults are runwayml/stable-diffusion-inpainting (9-channel
    UNet input) at full width; tests shrink the widths.
  - Transformer2D `proj_in`/`proj_out` are 1x1 convs, the checkpoint's
    layout; `interop.sd_from_numpy` reshapes the linear (c, c) layout the
    JAX init emits to (c, c, 1, 1).

The numerics are the JAX package's: group and layer norms with eps 1e-5,
the exact (erf) GELU in GEGLU, plain softmax attention in float32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from goi_tpu_torch.query._nn import (fan_in, group_norm, init_by_rule_,
                                     layer_norm, linear, merge_heads, randn,
                                     split_heads)

EPS = 1e-5
# the Transformer2D input norm's groups (capped at the channels), fixed in
# SD-1.x whatever the resnets' norm_groups
XFORMER_GROUPS = 32


@dataclasses.dataclass(frozen=True)
class SDConfig:
    """SD-1.x shapes. Defaults match runwayml/stable-diffusion-
    inpainting (9-ch UNet input) at full size; tests shrink widths."""

    in_channels: int = 9            # 4 latent + 1 mask + 4 masked-latent
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    attention_head_dim: int = 8     # heads; head size = ch // heads
    cross_attention_dim: int = 768
    norm_groups: int = 32
    # VAE
    vae_block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    vae_layers_per_block: int = 2
    latent_channels: int = 4
    scaling_factor: float = 0.18215
    # schedule (scaled_linear, ref diffusers PNDM/DDIM defaults)
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012


def alphas_cumprod(cfg: SDConfig, device="cuda") -> torch.Tensor:
    betas = torch.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5,
                           cfg.num_train_timesteps, device=device) ** 2
    return torch.cumprod(1.0 - betas, 0)


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding, diffusers Timesteps(flip_sin_to_cos=True,
    downscale_freq_shift=0) convention: [cos | sin]."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    ang = t.to(torch.float32)[:, None] * freqs[None]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def _conv(ci, co, k=3, stride=1, pad=None, device="cuda") -> nn.Conv2d:
    return nn.Conv2d(ci, co, k, stride=stride,
                     padding=k // 2 if pad is None else pad, device=device)


# ---------------------------------------------------------------------------
# layers (diffusers names)
# ---------------------------------------------------------------------------

class ResnetBlock2D(nn.Module):
    def __init__(self, ci, co, groups, temb_dim=None, device="cuda"):
        super().__init__()
        self.norm1 = group_norm(groups, ci, eps=EPS, device=device)
        self.conv1 = _conv(ci, co, device=device)
        self.time_emb_proj = (None if temb_dim is None else
                              linear(temb_dim, co, device=device))
        self.norm2 = group_norm(groups, co, eps=EPS, device=device)
        self.conv2 = _conv(co, co, device=device)
        self.conv_shortcut = (None if ci == co else
                              _conv(ci, co, k=1, device=device))

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if self.time_emb_proj is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Attention(nn.Module):
    """diffusers Attention (to_q/to_k/to_v/to_out.0), plain softmax
    attention in float32."""

    def __init__(self, dim, kv_dim, heads, bias, device="cuda"):
        super().__init__()
        self.heads = heads
        self.to_q = linear(dim, dim, bias=bias, device=device)
        self.to_k = linear(kv_dim, dim, bias=bias, device=device)
        self.to_v = linear(kv_dim, dim, bias=bias, device=device)
        self.to_out = nn.ModuleList([linear(dim, dim, device=device)])

    def forward(self, x, ctx):
        q = split_heads(self.to_q(x), self.heads)
        k = split_heads(self.to_k(ctx), self.heads)
        v = split_heads(self.to_v(ctx), self.heads)
        a = torch.softmax((q @ k.transpose(-1, -2)) * q.shape[-1] ** -0.5,
                          dim=-1)
        return self.to_out[0](merge_heads(a @ v))


class GEGLU(nn.Module):
    def __init__(self, dim, inner, device="cuda"):
        super().__init__()
        self.proj = linear(dim, 2 * inner, device=device)

    def forward(self, x):
        a, g = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(g, approximate="none")


class FeedForward(nn.Module):
    def __init__(self, dim, device="cuda"):
        super().__init__()
        # net.1 is diffusers' dropout (p = 0): no parameters
        self.net = nn.ModuleList([GEGLU(dim, 4 * dim, device), nn.Identity(),
                                  linear(4 * dim, dim, device=device)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim, ctx_dim, heads, device="cuda"):
        super().__init__()
        self.norm1 = layer_norm(dim, eps=EPS, device=device)
        self.attn1 = Attention(dim, dim, heads, False, device)
        self.norm2 = layer_norm(dim, eps=EPS, device=device)
        self.attn2 = Attention(dim, ctx_dim, heads, False, device)
        self.norm3 = layer_norm(dim, eps=EPS, device=device)
        self.ff = FeedForward(dim, device)

    def forward(self, x, ctx):
        h = self.norm1(x)
        x = x + self.attn1(h, h)
        x = x + self.attn2(self.norm2(x), ctx)
        return x + self.ff(self.norm3(x))


class Transformer2DModel(nn.Module):
    """GN -> proj_in (1x1 conv) -> blocks -> proj_out (1x1 conv) + skip."""

    def __init__(self, dim, ctx_dim, heads, device="cuda"):
        super().__init__()
        self.norm = group_norm(XFORMER_GROUPS, dim, eps=EPS, device=device)
        self.proj_in = _conv(dim, dim, k=1, device=device)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(dim, ctx_dim, heads, device)])
        self.proj_out = _conv(dim, dim, k=1, device=device)

    def forward(self, x, ctx):
        b, c, h, w = x.shape
        y = self.proj_in(self.norm(x)).permute(0, 2, 3, 1).reshape(
            b, h * w, c)
        for blk in self.transformer_blocks:
            y = blk(y, ctx)
        return self.proj_out(y.reshape(b, h, w, c).permute(0, 3, 1, 2)) + x


class VAEAttention(Attention):
    """AutoencoderKL mid-block single-head attention over the pixels."""

    def __init__(self, c, groups, device="cuda"):
        super().__init__(c, c, 1, True, device)
        self.group_norm = group_norm(groups, c, eps=EPS, device=device)

    def forward(self, x, ctx=None):
        b, c, h, w = x.shape
        y = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        y = super().forward(y, y)
        return x + y.reshape(b, h, w, c).permute(0, 3, 1, 2)


class Downsample2D(nn.Module):
    """Stride-2 3x3 conv; the VAE's pads (0, 1, 0, 1) and the conv none."""

    def __init__(self, c, asymmetric: bool, device="cuda"):
        super().__init__()
        self.asymmetric = asymmetric
        self.conv = _conv(c, c, stride=2, pad=0 if asymmetric else 1,
                          device=device)

    def forward(self, x):
        if self.asymmetric:
            x = F.pad(x, (0, 1, 0, 1))
        return self.conv(x)


class Upsample2D(nn.Module):
    """Nearest 2x, then a 3x3 conv."""

    def __init__(self, c, device="cuda"):
        super().__init__()
        self.conv = _conv(c, c, device=device)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class _Block(nn.Module):
    """A down, mid or up block: resnets, and attentions, downsamplers or
    upsamplers where the layout has them (the parent runs the block)."""

    def __init__(self, resnets, attentions=None, downsamplers=None,
                 upsamplers=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        for name, mods in (("attentions", attentions),
                           ("downsamplers", downsamplers),
                           ("upsamplers", upsamplers)):
            setattr(self, name, None if mods is None else nn.ModuleList(mods))


class TimestepEmbedding(nn.Module):
    def __init__(self, ci, co, device="cuda"):
        super().__init__()
        self.linear_1 = linear(ci, co, device=device)
        self.linear_2 = linear(co, co, device=device)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


# ---------------------------------------------------------------------------
# UNet
# ---------------------------------------------------------------------------

class UNet2DCondition(nn.Module):
    """The SD-1.x UNet2DConditionModel: CrossAttnDownBlock2D x (n-1) +
    DownBlock2D / cross-attention mid block / UpBlock2D +
    CrossAttnUpBlock2D x (n-1)."""

    def __init__(self, cfg: SDConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        ch = cfg.block_out_channels
        n, lpb, g = len(ch), cfg.layers_per_block, cfg.norm_groups
        heads, cd, temb = cfg.attention_head_dim, cfg.cross_attention_dim, \
            4 * ch[0]

        def resnet(ci, co):
            return ResnetBlock2D(ci, co, g, temb, device)

        def xformer(c):
            return Transformer2DModel(c, cd, heads, device)

        self.time_embedding = TimestepEmbedding(ch[0], temb, device)
        self.conv_in = _conv(cfg.in_channels, ch[0], device=device)
        skips, ci = [ch[0]], ch[0]
        down = []
        for i, co in enumerate(ch):
            cross = i < n - 1
            res, att = [], []
            for _ in range(lpb):
                res.append(resnet(ci, co))
                ci = co
                if cross:
                    att.append(xformer(co))
                skips.append(co)
            if cross:
                skips.append(co)
            down.append(_Block(res, att if cross else None,
                               downsamplers=[Downsample2D(co, False, device)]
                               if cross else None))
        self.down_blocks = nn.ModuleList(down)
        self.mid_block = _Block([resnet(ci, ci), resnet(ci, ci)],
                                [xformer(ci)])
        up = []
        for i, co in enumerate(reversed(ch)):
            res, att = [], []
            for _ in range(lpb + 1):
                res.append(resnet(ci + skips.pop(), co))
                ci = co
                if i > 0:
                    att.append(xformer(co))
            up.append(_Block(res, att if i > 0 else None,
                             upsamplers=None if i == n - 1 else
                             [Upsample2D(co, device)]))
        self.up_blocks = nn.ModuleList(up)
        self.conv_norm_out = group_norm(g, ci, eps=EPS, device=device)
        self.conv_out = _conv(ci, cfg.out_channels, device=device)

    def forward(self, sample: torch.Tensor, t: torch.Tensor,
                context: torch.Tensor) -> torch.Tensor:
        """sample (B, in_ch, H, W), t (B,) int, context (B, 77, cross_dim)
        -> eps (B, out_ch, H, W)."""
        temb = self.time_embedding(timestep_embedding(
            t, self.cfg.block_out_channels[0]))
        x = self.conv_in(sample)
        skips = [x]
        for blk in self.down_blocks:
            for j, res in enumerate(blk.resnets):
                x = res(x, temb)
                if blk.attentions is not None:
                    x = blk.attentions[j](x, context)
                skips.append(x)
            if blk.downsamplers is not None:
                x = blk.downsamplers[0](x)
                skips.append(x)
        mid = self.mid_block
        x = mid.resnets[1](mid.attentions[0](mid.resnets[0](x, temb),
                                             context), temb)
        for blk in self.up_blocks:
            for j, res in enumerate(blk.resnets):
                x = res(torch.cat([x, skips.pop()], dim=1), temb)
                if blk.attentions is not None:
                    x = blk.attentions[j](x, context)
            if blk.upsamplers is not None:
                x = blk.upsamplers[0](x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


# ---------------------------------------------------------------------------
# VAE
# ---------------------------------------------------------------------------

def _vae_mid(c, groups, device):
    return _Block([ResnetBlock2D(c, c, groups, None, device),
                   ResnetBlock2D(c, c, groups, None, device)],
                  [VAEAttention(c, groups, device)])


def _run_mid(mid, x):
    return mid.resnets[1](mid.attentions[0](mid.resnets[0](x)))


class Encoder(nn.Module):
    def __init__(self, cfg: SDConfig, device="cuda"):
        super().__init__()
        ch, g = cfg.vae_block_out_channels, cfg.norm_groups
        self.conv_in = _conv(3, ch[0], device=device)
        ci, down = ch[0], []
        for i, co in enumerate(ch):
            res = []
            for _ in range(cfg.vae_layers_per_block):
                res.append(ResnetBlock2D(ci, co, g, None, device))
                ci = co
            down.append(_Block(res, downsamplers=None if i == len(ch) - 1
                               else [Downsample2D(co, True, device)]))
        self.down_blocks = nn.ModuleList(down)
        self.mid_block = _vae_mid(ci, g, device)
        self.conv_norm_out = group_norm(g, ci, eps=EPS, device=device)
        self.conv_out = _conv(ci, 2 * cfg.latent_channels, device=device)

    def forward(self, x):
        x = self.conv_in(x)
        for blk in self.down_blocks:
            for res in blk.resnets:
                x = res(x)
            if blk.downsamplers is not None:
                x = blk.downsamplers[0](x)
        x = _run_mid(self.mid_block, x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class Decoder(nn.Module):
    def __init__(self, cfg: SDConfig, device="cuda"):
        super().__init__()
        rev, g = list(reversed(cfg.vae_block_out_channels)), cfg.norm_groups
        self.conv_in = _conv(cfg.latent_channels, rev[0], device=device)
        self.mid_block = _vae_mid(rev[0], g, device)
        ci, up = rev[0], []
        for i, co in enumerate(rev):
            res = []
            for _ in range(cfg.vae_layers_per_block + 1):
                res.append(ResnetBlock2D(ci, co, g, None, device))
                ci = co
            up.append(_Block(res, upsamplers=None if i == len(rev) - 1
                             else [Upsample2D(co, device)]))
        self.up_blocks = nn.ModuleList(up)
        self.conv_norm_out = group_norm(g, ci, eps=EPS, device=device)
        self.conv_out = _conv(ci, 3, device=device)

    def forward(self, z):
        x = _run_mid(self.mid_block, self.conv_in(z))
        for blk in self.up_blocks:
            for res in blk.resnets:
                x = res(x)
            if blk.upsamplers is not None:
                x = blk.upsamplers[0](x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class AutoencoderKL(nn.Module):
    """diffusers AutoencoderKL: encoder + quant_conv, post_quant_conv +
    decoder."""

    def __init__(self, cfg: SDConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        lat = cfg.latent_channels
        self.encoder = Encoder(cfg, device)
        self.decoder = Decoder(cfg, device)
        self.quant_conv = _conv(2 * lat, 2 * lat, k=1, device=device)
        self.post_quant_conv = _conv(lat, lat, k=1, device=device)

    def encode(self, img: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """img (B, 3, H, W) in [-1, 1] -> scaled latents
        (B, latent_ch, H/8, W/8). The posterior's mean unless a generator
        is given (the reference samples it,
        ref:guidance/sd_inpainting_utils.py:113-116)."""
        mean, logvar = self.quant_conv(self.encoder(img)).chunk(2, dim=1)
        if generator is not None:
            std = torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0))
            mean = mean + std * torch.randn(
                mean.shape, generator=generator,
                device=generator.device).to(mean.device)
        return mean * self.cfg.scaling_factor

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Scaled latents (B, latent_ch, h, w) -> image (B, 3, 8h, 8w) in
        [-1, 1] (ref:guidance/sd_inpainting_lods_utils.py:403-409)."""
        return self.decoder(self.post_quant_conv(
            latents / self.cfg.scaling_factor))


# ---------------------------------------------------------------------------
# init + diffusers conversion
# ---------------------------------------------------------------------------

def init_sd_(module: nn.Module, generator: torch.Generator,
             scale: float = 0.1) -> nn.Module:
    """Random weights with the JAX package's init rule (init_sd_params),
    drawn from `generator`: biases 0, norm weights 1, other weights
    N(0, 1) * scale / sqrt(fan_in)."""
    def rule(name, shape, g):
        if name.endswith(".bias"):
            return torch.zeros(shape)
        if "norm" in name.split(".")[-2]:
            return torch.ones(shape)
        return randn(shape, scale / math.sqrt(fan_in(shape)), g)

    return init_by_rule_(module, generator, rule)


def convert_diffusers_state(unet_sd=None, vae_sd=None) -> dict:
    """diffusers UNet2DConditionModel / AutoencoderKL state_dicts -> one
    flat {diffusers key: float32 array} dict, the JAX package's params
    format (np.savez it once; `TorchDiffusionBackend.from_npz` and
    `interop.sd_from_numpy` load it). The state dicts themselves load
    straight into `UNet2DCondition` / `AutoencoderKL`."""
    out = {}
    for sd in (unet_sd or {}, vae_sd or {}):
        for k, v in sd.items():
            out[k] = np.asarray(
                v.detach().cpu().float().numpy() if hasattr(v, "detach")
                else v, np.float32)
    return out


class TorchDiffusionBackend:
    """DiffusionBackend-protocol provider around a frozen UNet and VAE,
    on the UNet's device. The modules' parameters take no gradient; the
    guidance takes gradients with respect to the images through
    `encode_images`."""

    def __init__(self, unet: UNet2DCondition, vae: AutoencoderKL,
                 cfg: SDConfig):
        self.cfg = cfg
        self.unet = unet.eval().requires_grad_(False)
        self.vae = vae.eval().requires_grad_(False)
        self.alphas = alphas_cumprod(cfg, next(unet.parameters()).device)
        self.num_train_timesteps = cfg.num_train_timesteps
        self.scaling_factor = cfg.scaling_factor

    @staticmethod
    def from_npz(path: str, cfg: SDConfig,
                 device="cuda") -> "TorchDiffusionBackend":
        """A converted checkpoint (`convert_diffusers_state`, or the JAX
        package's params) saved with np.savez."""
        from goi_tpu_torch import interop
        with np.load(path) as f:
            return interop.sd_from_numpy(dict(f), cfg, device)

    def encode_images(self, imgs: torch.Tensor) -> torch.Tensor:
        return self.vae.encode(imgs)

    def unet_eps(self, latent_in: torch.Tensor, t: torch.Tensor,
                 cond: torch.Tensor) -> torch.Tensor:
        return self.unet(latent_in, t, cond)

    def decode_latents(self, latents: torch.Tensor) -> torch.Tensor:
        """Scaled latents -> images in [0, 1]
        (ref:guidance/sd_inpainting_utils.py decode_latents)."""
        return torch.clamp(self.vae.decode(latents) / 2 + 0.5, 0.0, 1.0)
