"""DDIM sampling on top of the DiffusionBackend protocol, and the random
draws of the guidance.

Counterpart of goi_tpu/guidance/samplers.py. The reference runs full
denoising loops in three places: the SD-inpaint `produce_latents`
(ref:guidance/sd_inpainting_lods_utils.py:330-403), the SDXL 1024px
inpaint pipeline (ref:guidance/sdxl_utils.py:74-125) and Zero123
`refine` (ref:guidance/zero123_utils.py:75-118), all via diffusers'
DDIMScheduler with eta=0: leading-spaced timesteps with the SD
steps_offset of 1, `add_noise`, and the deterministic DDIM update. The
loop over the step list runs on the host, one UNet call a step.

Every random draw of the guidance goes through `_draw_noise`, `_draw_t`
and `_draw_uniform`, from an explicit `torch.Generator` (the JAX package
splits a PRNG key); tests replace them with the JAX package's draws.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from goi_tpu_torch.utils.image import resize_linear


def _draw_noise(generator: torch.Generator, shape, device) -> torch.Tensor:
    """Standard normal draws of `shape`."""
    return torch.randn(tuple(shape), generator=generator,
                       device=generator.device).to(device)


def _draw_t(generator: torch.Generator, batch: int, low: int, high: int,
            device) -> torch.Tensor:
    """(batch,) integer timesteps uniform in [low, high)."""
    return torch.randint(low, high, (batch,), generator=generator,
                         device=generator.device).to(device)


def _draw_uniform(generator: torch.Generator, low: float, high: float,
                  device) -> torch.Tensor:
    """One float32 draw uniform in [low, high), a 0-d tensor."""
    u = torch.rand((), generator=generator, device=generator.device)
    return (low + (high - low) * u).to(device)


def ddim_timesteps(num_train_timesteps: int, num_steps: int,
                   steps_offset: int = 1) -> np.ndarray:
    """Descending timestep list, diffusers 'leading' spacing
    (DDIMScheduler.set_timesteps with steps_offset=1, the SD config)."""
    ratio = num_train_timesteps // num_steps
    ts = (np.arange(num_steps) * ratio).round()[::-1].astype(np.int64)
    return np.clip(ts + steps_offset, 0, num_train_timesteps - 1)


def add_noise(alphas: torch.Tensor, x0: torch.Tensor, noise: torch.Tensor,
              t) -> torch.Tensor:
    a = alphas[t]
    return torch.sqrt(a) * x0 + torch.sqrt(1.0 - a) * noise


def ddim_step(alphas: torch.Tensor, eps: torch.Tensor, t: int, t_prev: int,
              x: torch.Tensor) -> torch.Tensor:
    """Deterministic (eta=0) DDIM update x_t -> x_{t_prev}
    (DDIMScheduler.step): reconstruct x0 from the eps prediction and
    re-noise at the previous level."""
    a_t = alphas[t]
    a_prev = alphas[t_prev] if t_prev >= 0 else torch.ones_like(a_t)
    x0 = (x - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
    return torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * eps


def mask_to_latent(m: torch.Tensor, size: int) -> torch.Tensor:
    """jax.image.resize(m, ..., "nearest") to (size, size): samples
    floor((i + 0.5) * in / out), torch's "nearest-exact"."""
    return F.interpolate(m, size=(size, size), mode="nearest-exact")


@torch.no_grad()
def inpaint_sample(backend, pos: torch.Tensor, neg: torch.Tensor,
                   images: torch.Tensor, masks: torch.Tensor, *,
                   generator: torch.Generator, num_steps: int = 50,
                   guidance_scale: float = 7.5, strength: float = 1.0,
                   img_size: int = 512,
                   latents: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full inpainting denoise: the role of `produce_latents` + decode
    (ref:guidance/sd_inpainting_lods_utils.py:330-409) and, at
    img_size=1024, of the SDXL inpaint pipeline call
    (ref:guidance/sdxl_utils.py:94-103).

    images (B,3,H,W) in [0,1]; masks (B,1,H,W), 1 = repaint. strength
    < 1 starts from the noised input image instead of pure noise
    (partial denoise, diffusers img2img convention: the first
    num_steps*(1-strength) steps are skipped). Returns (B,3,s,s) in
    [0,1]."""
    b = images.shape[0]
    r = img_size
    ls = r // 8
    imgs = resize_linear(images, (b, 3, r, r))
    m = (resize_linear(masks.to(torch.float32), (b, 1, r, r))
         >= 0.5).to(imgs.dtype)
    # normalize-then-mask (masked pixels 0 in [-1,1] space,
    # ref:guidance/sd_inpainting_utils.py:398-408)
    masked_latents = backend.encode_images((imgs * 2.0 - 1.0) * (1 - m))
    m_lat = mask_to_latent(m, ls)

    alphas = backend.alphas
    ts = ddim_timesteps(backend.num_train_timesteps, num_steps)
    dev = masked_latents.device
    if latents is None:
        if strength >= 1.0:
            latents = _draw_noise(
                generator, (b, masked_latents.shape[1], ls, ls), dev)
            start = 0
        else:
            init = min(int(num_steps * strength), num_steps)
            start = max(num_steps - init, 0)
            lat0 = backend.encode_images(imgs * 2.0 - 1.0)
            latents = add_noise(alphas, lat0,
                                _draw_noise(generator, lat0.shape, dev),
                                int(ts[start]))
    else:
        start = 0

    pos_b = pos[None].expand((b,) + tuple(pos.shape))
    neg_b = neg[None].expand((b,) + tuple(neg.shape))
    ratio = backend.num_train_timesteps // num_steps
    for t in ts[start:]:
        t_in = torch.full((b,), int(t), dtype=torch.int32, device=dev)
        lat_in = torch.cat([latents, m_lat, masked_latents], dim=1)
        e_pos = backend.unet_eps(lat_in, t_in, pos_b)
        e_neg = backend.unet_eps(lat_in, t_in, neg_b)
        eps = e_neg + guidance_scale * (e_pos - e_neg)
        latents = ddim_step(alphas, eps, int(t), int(t) - ratio, latents)
    return backend.decode_latents(latents)


class SDXLInpaint:
    """The reference's SDXL inpainting wrapper
    (ref:guidance/sdxl_utils.py:22-125): a whole-image 1024px inpaint
    used to rewrite dataset views during editing. The SDXL-specific
    micro-conditioning (pooled text embeds + time ids) is the backend's
    concern (its `unet_eps` closure carries them), so this class is the
    1024/128 sampler with the reference's defaults (strength 0.99, 20
    steps)."""

    def __init__(self, backend, pos_embedding: torch.Tensor,
                 neg_embedding: torch.Tensor, img_size: int = 1024):
        self.backend = backend
        self.pos = pos_embedding
        self.neg = neg_embedding
        self.img_size = img_size

    def inpaint(self, generator: torch.Generator, images: torch.Tensor,
                masks: torch.Tensor, *, num_inference_steps: int = 20,
                strength: float = 0.99,
                guidance_scale: float = 100.0) -> torch.Tensor:
        return inpaint_sample(
            self.backend, self.pos, self.neg, images, masks,
            generator=generator, num_steps=num_inference_steps,
            guidance_scale=guidance_scale, strength=strength,
            img_size=self.img_size)
