"""Score-distillation guidance (SDS) for scene editing.

Counterpart of goi_tpu/guidance/sds.py: the reference's guidance family
(ref:guidance/sd_inpainting_utils.py:124-308 plus the sd/sdxl/vsd/cds
variants) factored against a `DiffusionBackend` protocol:

  encode_images(imgs)    (B,3,img,img) -> latents (B,4,img/8,img/8)
  unet_eps(latent_in, t, cond)  noise prediction
  alphas                 cumulative alpha schedule (T,)

`guidance/sd_torch.py`'s `TorchDiffusionBackend` is one; the tests use
analytic ones. The SDS math is the reference's: masked-image latents for
the inpaint UNet's 9-channel input, dreamtime-style timestep annealing,
classifier-free guidance, loss = 0.5*MSE(latents, stopgrad(latents -
w(t)(eps_hat-eps))) restricted to the edit mask
(ref:sd_inpainting_utils.py:165-308).

Where the JAX package stops the gradient, the port computes under
`torch.no_grad()`: in an SDS step only the VAE encode of the rendered
frames keeps a graph, so the backward runs through the encoder and the
resize into the renderer and never through the UNet. Random draws come
from an explicit `torch.Generator` through samplers.py's draw helpers.
The image resize is `resize_linear`, jax.image.resize's antialiased
bilinear; the mask's resize to the latent grid is its "nearest".
"""

from __future__ import annotations

from typing import Optional, Protocol

import numpy as np
import torch
import torch.nn.functional as F

from goi_tpu_torch.guidance import samplers
from goi_tpu_torch.guidance.samplers import mask_to_latent
from goi_tpu_torch.utils.image import resize_linear


class DiffusionBackend(Protocol):
    alphas: torch.Tensor         # (num_train_timesteps,) cumprod alphas
    num_train_timesteps: int

    def encode_images(self, imgs: torch.Tensor) -> torch.Tensor: ...

    def unet_eps(self, latent_in: torch.Tensor, t: torch.Tensor,
                 cond: torch.Tensor) -> torch.Tensor: ...


def _batch(x: torch.Tensor, b: int) -> torch.Tensor:
    """An embedding broadcast to a leading batch of b."""
    return x[None].expand((b,) + tuple(x.shape))


def _resize_images(images: torch.Tensor, r: int) -> torch.Tensor:
    return resize_linear(images, (images.shape[0], 3, r, r))


def _binary_mask(masks: torch.Tensor, r: int, dtype) -> torch.Tensor:
    """The mask at (r, r): bilinear, then >= 0.5."""
    return (resize_linear(masks.to(torch.float32),
                          (masks.shape[0], 1, r, r)) >= 0.5).to(dtype)


def _anneal_t(step_ratio, T: int, lo: int, hi: int, b: int,
              device) -> torch.Tensor:
    """clip(round((1 - step_ratio) T), lo, hi) in float32, as the JAX
    package computes it on a traced step ratio
    (ref:sd_inpainting_utils.py:164-167)."""
    sr = torch.as_tensor(step_ratio, dtype=torch.float32)
    t = torch.clamp(torch.round((1.0 - sr) * T), lo, hi).to(torch.int64)
    return t.expand(b).to(device)


def _sds_loss(latents, grad, b, mask=None):
    """0.5 * |latents - stopgrad(latents - grad)|^2 / b, summed (under the
    latent mask when given)."""
    target = latents.detach() - grad
    mse = 0.5 * (latents - target) ** 2 / b
    if mask is not None:
        mse = mse * mask.expand_as(mse)
    return torch.sum(mse)


class InpaintSDS:
    """SDS guidance against an inpainting diffusion backend."""

    def __init__(self, backend: DiffusionBackend,
                 pos_embedding: torch.Tensor, neg_embedding: torch.Tensor,
                 t_range=(0.02, 0.98), latent_size: int = 64,
                 img_size: int = 512):
        self.backend = backend
        self.img_size = img_size
        self.pos = pos_embedding
        self.neg = neg_embedding
        T = backend.num_train_timesteps
        self.min_step = int(T * t_range[0])
        self.max_step = int(T * t_range[1])
        self.latent_size = latent_size

    def _pick_t(self, generator, batch, step_ratio, device):
        if step_ratio is not None:
            return _anneal_t(step_ratio, self.backend.num_train_timesteps,
                             self.min_step, self.max_step, batch, device)
        return samplers._draw_t(generator, batch, self.min_step,
                                self.max_step + 1, device)

    def _noisy(self, generator, latents, b, step_ratio):
        """(t, w(t), noise, the noised stop-gradient latents)."""
        t = self._pick_t(generator, b, step_ratio, latents.device)
        a_t = self.backend.alphas[t][:, None, None, None]
        noise = samplers._draw_noise(generator, latents.shape,
                                     latents.device)
        noisy = torch.sqrt(a_t) * latents.detach() \
            + torch.sqrt(1 - a_t) * noise
        return t, 1.0 - a_t, noise, noisy

    def train_step(self, generator: torch.Generator, images: torch.Tensor,
                   masks: torch.Tensor, *,
                   step_ratio: Optional[float] = None,
                   guidance_scale: float = 7.5) -> torch.Tensor:
        """images (B,3,H,W) in [0,1] WITH gradient flow; masks (B,1,H,W)
        binary (1 = editable). Returns the scalar SDS loss
        (ref:sd_inpainting_utils.py:124-308)."""
        b = images.shape[0]
        r = self.img_size
        imgs512 = _resize_images(images, r)
        m512 = _binary_mask(masks, r, images.dtype)
        latents = self.backend.encode_images(imgs512 * 2.0 - 1.0)
        with torch.no_grad():
            # normalize FIRST, then mask, so masked pixels are 0 in the
            # normalized space (ref:guidance/sd_inpainting_utils.py:
            # 398-408: mask-then-normalize would feed -1 "black" into the
            # 9-channel inpaint UNet)
            masked_latents = self.backend.encode_images(
                (imgs512 * 2.0 - 1.0) * (1 - m512))
            m_lat = mask_to_latent(m512, self.latent_size)
            t, w, noise, noisy = self._noisy(generator, latents, b,
                                             step_ratio)
            latent_in = torch.cat([noisy, m_lat, masked_latents], dim=1)
            eps_pos = self.backend.unet_eps(latent_in, t, _batch(self.pos, b))
            eps_neg = self.backend.unet_eps(latent_in, t, _batch(self.neg, b))
            eps_hat = eps_neg + guidance_scale * (eps_pos - eps_neg)
            grad = torch.nan_to_num(w * (eps_hat - noise))
        return _sds_loss(latents, grad, b, m_lat)


class PlainSDS:
    """Non-inpainting SDS against a 4-channel UNet (the role of
    ref:guidance/sd_utils.py train_step): same annealing/CFG/weighting,
    latent input is just the noisy latents."""

    def __init__(self, backend: DiffusionBackend,
                 pos_embedding: torch.Tensor, neg_embedding: torch.Tensor,
                 t_range=(0.02, 0.98), latent_size: int = 64,
                 img_size: int = 512):
        self._inner = InpaintSDS(backend, pos_embedding, neg_embedding,
                                 t_range, latent_size, img_size)

    def train_step(self, generator: torch.Generator, images: torch.Tensor,
                   *, step_ratio: Optional[float] = None,
                   guidance_scale: float = 7.5) -> torch.Tensor:
        b = images.shape[0]
        s = self._inner
        latents = s.backend.encode_images(
            _resize_images(images, s.img_size) * 2.0 - 1.0)
        with torch.no_grad():
            t, w, noise, noisy = s._noisy(generator, latents, b, step_ratio)
            e_pos = s.backend.unet_eps(noisy, t, _batch(s.pos, b))
            e_neg = s.backend.unet_eps(noisy, t, _batch(s.neg, b))
            eps_hat = e_neg + guidance_scale * (e_pos - e_neg)
            grad = torch.nan_to_num(w * (eps_hat - noise))
        return _sds_loss(latents, grad, b)


class VSD:
    """Variational score distillation (ProlificDreamer; the role of
    ref:guidance/vsd_utils.py). The pretrained score comes from the
    backend; the particle score is any trainable eps-net
    `lora_eps(params, noisy, t, cond)` (the reference uses a LoRA'd UNet
    copy, ref:vsd_utils.py:109-162). Alternate:
      train_step      -> loss for the renderer parameters,
      lora_loss       -> diffusion loss training the particle score."""

    def __init__(self, backend: DiffusionBackend, lora_eps,
                 pos_embedding: torch.Tensor, neg_embedding: torch.Tensor,
                 t_range=(0.02, 0.98)):
        self._s = InpaintSDS(backend, pos_embedding, neg_embedding,
                             t_range)
        self.backend = backend
        self.lora_eps = lora_eps

    def _latents(self, images):
        return self.backend.encode_images(
            _resize_images(images, self._s.img_size) * 2.0 - 1.0)

    def train_step(self, generator: torch.Generator, lora_params, images,
                   *, step_ratio=None, guidance_scale: float = 7.5):
        s = self._s
        latents = self._latents(images)
        b = latents.shape[0]
        with torch.no_grad():
            t, w, noise, noisy = s._noisy(generator, latents, b, step_ratio)
            e_pos = self.backend.unet_eps(noisy, t, _batch(s.pos, b))
            e_neg = self.backend.unet_eps(noisy, t, _batch(s.neg, b))
            eps_pre = e_neg + guidance_scale * (e_pos - e_neg)
            eps_particle = self.lora_eps(lora_params, noisy, t,
                                         _batch(s.pos, b))
            grad = torch.nan_to_num(w * (eps_pre - eps_particle))
        return _sds_loss(latents, grad, b)

    def lora_loss(self, generator: torch.Generator, lora_params, images):
        """Standard diffusion loss fitting the particle score to the
        current render distribution (ref:vsd_utils.py train_lora)."""
        with torch.no_grad():
            latents = self._latents(images)
            b = latents.shape[0]
            t = self._s._pick_t(generator, b, None, latents.device)
            a_t = self.backend.alphas[t][:, None, None, None]
            noise = samplers._draw_noise(generator, latents.shape,
                                         latents.device)
            noisy = torch.sqrt(a_t) * latents + torch.sqrt(1 - a_t) * noise
        pred = self.lora_eps(lora_params, noisy, t, _batch(self._s.pos, b))
        return torch.mean((pred - noise) ** 2)


class CDS:
    """The reference's two-timestep contrastive/SDI scheme
    (ref:guidance/sd_cds_utils.py:178-318): VE noise sigma=sqrt(2t),
    annealed t2 with t1 ~ U(t2+0.1, t2+0.2), an ODE step from t1 to t2,
    and loss = w(t2) * MSE(x0_pred re-noised at t1, sg(eps_hat_t2))."""

    def __init__(self, backend: DiffusionBackend,
                 pos_embedding: torch.Tensor, neg_embedding: torch.Tensor,
                 t_range=(0.02, 0.98)):
        self._s = InpaintSDS(backend, pos_embedding, neg_embedding,
                             t_range)
        self.backend = backend
        self.min_t, self.max_t = t_range

    def train_step(self, generator: torch.Generator, images, *,
                   step_ratio: float, guidance_scale: float = 100.0):
        s = self._s
        b = images.shape[0]
        latents = self.backend.encode_images(
            _resize_images(images, s.img_size) * 2.0 - 1.0)
        T = self.backend.num_train_timesteps
        dev = latents.device
        with torch.no_grad():
            t2 = self.max_t - (self.max_t - self.min_t) * torch.sqrt(
                torch.tensor(step_ratio, dtype=torch.float32, device=dev))
            t1 = t2 + samplers._draw_uniform(generator, 0.1, 0.2, dev)
            t1s = (t1 * T).to(torch.int32).expand(b)
            t2s = (t2 * T).to(torch.int32).expand(b)
            sig1 = torch.sqrt(2.0 * t1)
            sig2 = torch.sqrt(2.0 * t2)
            noise = samplers._draw_noise(generator, latents.shape, dev)
            noisy1 = latents.detach() + sig1 * noise

            def cfg_eps(noisy, t):
                e_pos = self.backend.unet_eps(noisy, t, _batch(s.pos, b))
                e_neg = self.backend.unet_eps(noisy, t, _batch(s.neg, b))
                return e_neg + guidance_scale * (e_pos - e_neg)

            eps1 = cfg_eps(noisy1, t1s)
            di = (noisy1 - eps1) / sig1
            noisy2 = noisy1 + (sig2 - sig1) * di
            x0_sub = noise - di
            eps2 = cfg_eps(noisy2, t1s)
            w2 = (1.0 - self.backend.alphas[t2s])[:, None, None, None]
        x0_pred = latents + sig1 * x0_sub
        return torch.sum(w2 * (x0_pred - eps2) ** 2)


class LODSInpaintSDS:
    """LODS: inpainting SDS with a LEARNED unconditional embedding
    (ref:guidance/sd_inpainting_lods_utils.py:117-123,134-326). Two
    losses per step; the caller owns the trainable `uncond_emb` (init = a
    copy of the negative prompt embedding, ref::118) and optimizes it
    with its own Adam:

      sds_loss(generator, uncond_emb, images, masks, ...)  gradient for
        the renderer; noise-pred combination and grad clip follow
        ref::253 (eps_c + (1-gs)/gs * eps_u - noise/gs, clamp
        +-grad_clip).
      embedding_loss(generator, uncond_emb, images, masks)  standard
        diffusion MSE training the uncond embedding to explain the
        current renders (ref::137-165 train_embedding, t ~ U(0, T)).
    """

    def __init__(self, backend: DiffusionBackend,
                 pos_embedding: torch.Tensor, neg_embedding: torch.Tensor,
                 t_range=(0.02, 0.98), latent_size: int = 64,
                 img_size: int = 512, grad_clip: float = 10.0):
        self._s = InpaintSDS(backend, pos_embedding, neg_embedding,
                             t_range, latent_size, img_size)
        self.backend = backend
        self.grad_clip = grad_clip

    def init_uncond(self) -> torch.Tensor:
        """Initial learnable embedding = the negative prompt's
        (ref:sd_inpainting_lods_utils.py:118)."""
        return self._s.neg.detach().clone()

    def _prep(self, images, masks):
        """(latents with their graph, masked latents, latent mask)."""
        s = self._s
        imgs512 = _resize_images(images, s.img_size)
        latents = self.backend.encode_images(imgs512 * 2.0 - 1.0)
        with torch.no_grad():
            m512 = _binary_mask(masks, s.img_size, images.dtype)
            masked = self.backend.encode_images(
                (imgs512 * 2.0 - 1.0) * (1 - m512))
            m_lat = mask_to_latent(m512, s.latent_size)
        return latents, masked, m_lat

    def sds_loss(self, generator: torch.Generator, uncond_emb, images,
                 masks, *, step_ratio=None,
                 guidance_scale: float = 7.5) -> torch.Tensor:
        s = self._s
        b = images.shape[0]
        latents, masked, m_lat = self._prep(images, masks)
        dev = latents.device
        with torch.no_grad():
            if step_ratio is not None:
                # LODS anneal: t = sr*(min-max)+max (ref::211)
                sr = torch.tensor(step_ratio, dtype=torch.float32)
                t = torch.round(sr * (s.min_step - s.max_step)
                                + s.max_step).to(torch.int64).expand(b)
                t = t.to(dev)
            else:
                t = samplers._draw_t(generator, b, s.min_step,
                                     s.max_step + 1, dev)
            a_t = self.backend.alphas[t][:, None, None, None]
            noise = samplers._draw_noise(generator, latents.shape, dev)
            noisy = torch.sqrt(a_t) * latents.detach() \
                + torch.sqrt(1 - a_t) * noise
            lat_in = torch.cat([noisy, m_lat, masked], dim=1)

            def eps(cond):
                cond_b = _batch(cond, b) if cond.dim() == 2 else cond
                return self.backend.unet_eps(lat_in, t, cond_b)

            e_cond = eps(s.pos)
            e_unc = eps(uncond_emb)
            gs = guidance_scale
            # diffusers-aligned guidance definition (ref::253)
            pred = e_cond + (1.0 - gs) / gs * e_unc - noise / gs
            grad = torch.clamp(torch.nan_to_num((1.0 - a_t) * pred),
                               -self.grad_clip, self.grad_clip)
        return _sds_loss(latents, grad, b, m_lat)

    def embedding_loss(self, generator: torch.Generator, uncond_emb,
                       images, masks) -> torch.Tensor:
        with torch.no_grad():
            latents, masked, m_lat = self._prep(images, masks)
            b = latents.shape[0]
            T = self.backend.num_train_timesteps
            t = samplers._draw_t(generator, b, 0, T, latents.device)
            a_t = self.backend.alphas[t][:, None, None, None]
            noise = samplers._draw_noise(generator, latents.shape,
                                         latents.device)
            noisy = torch.sqrt(a_t) * latents + torch.sqrt(1 - a_t) * noise
            lat_in = torch.cat([noisy, m_lat, masked], dim=1)
        pred = self.backend.unet_eps(lat_in, t, _batch(uncond_emb, b))
        return torch.mean((pred - noise) ** 2)


class Zero123Backend(Protocol):
    """DiffusionBackend plus the Zero123 towers (ref:guidance/
    zero123_utils.py:28-44): a CLIP image encoder, the
    clip_camera_projection MLP, and the latent-channel image
    conditioning (8-channel UNet input)."""
    alphas: torch.Tensor
    num_train_timesteps: int
    scaling_factor: float

    def encode_images(self, imgs: torch.Tensor) -> torch.Tensor: ...

    def decode_latents(self, latents: torch.Tensor) -> torch.Tensor: ...

    def image_embed(self, imgs: torch.Tensor) -> torch.Tensor: ...

    def cam_project(self, cc: torch.Tensor) -> torch.Tensor: ...

    def unet_eps(self, latent_in: torch.Tensor, t: torch.Tensor,
                 cond: torch.Tensor) -> torch.Tensor: ...


class Zero123SDS:
    """Novel-view SDS (ref:guidance/zero123_utils.py:15-171): the
    condition is a reference image plus the camera delta, not text.
    cc_emb = proj([clip_img_embed, T]) with
    T = [rad(elev), sin(rad(az)), cos(rad(az)), radius] (stable
    variant: last term rad(90+default_elev), ref::66-73); the latent
    input concatenates the reference image's (unscaled) VAE latents in
    channels; the unconditional branch zeroes both."""

    def __init__(self, backend: Zero123Backend,
                 t_range=(0.02, 0.98), latent_size: int = 32,
                 img_size: int = 256, stable: bool = False):
        self.backend = backend
        T = backend.num_train_timesteps
        self.min_step = int(T * t_range[0])
        self.max_step = int(T * t_range[1])
        self.latent_size = latent_size
        self.img_size = img_size
        self.stable = stable
        self.embeddings = None

    @torch.no_grad()
    def set_image(self, image: torch.Tensor) -> None:
        """Reference view (B,3,H,W) in [0,1] -> cached [clip embed,
        unscaled vae latents] (ref::56-64 get_img_embeds)."""
        x = _resize_images(image, self.img_size)
        c = self.backend.image_embed(x)
        v = self.backend.encode_images(x * 2.0 - 1.0) \
            / self.backend.scaling_factor
        self.embeddings = (c, v)

    def _cam_T(self, elevation, azimuth, radius,
               default_elevation: float = 0.0) -> torch.Tensor:
        dev = self.embeddings[0].device if self.embeddings else None
        el = torch.deg2rad(torch.as_tensor(elevation, dtype=torch.float32,
                                           device=dev))
        az = torch.deg2rad(torch.as_tensor(azimuth, dtype=torch.float32,
                                           device=dev))
        if self.stable:
            last = torch.full_like(
                el, float(np.deg2rad(90.0 + default_elevation)))
        else:
            last = torch.as_tensor(radius, dtype=torch.float32, device=dev)
        return torch.stack([el, torch.sin(az), torch.cos(az), last],
                           dim=-1)[:, None, :]      # (B, 1, 4)

    def _cond(self, batch):
        c, v = self.embeddings
        if batch % c.shape[0]:
            raise ValueError(
                f"render batch {batch} must be a multiple of the "
                f"set_image() reference batch {c.shape[0]}")
        reps = batch // c.shape[0]
        return c.repeat(reps, 1, 1), v.repeat(reps, 1, 1, 1)

    def _cfg_eps(self, latents, t, cc, v, guidance_scale):
        e_cond = self.backend.unet_eps(torch.cat([latents, v], dim=1), t, cc)
        e_unc = self.backend.unet_eps(
            torch.cat([latents, torch.zeros_like(v)], dim=1), t,
            torch.zeros_like(cc))
        return e_unc + guidance_scale * (e_cond - e_unc)

    def train_step(self, generator: torch.Generator, images: torch.Tensor,
                   elevation, azimuth, radius, *, step_ratio=None,
                   guidance_scale: float = 5.0,
                   default_elevation: float = 0.0) -> torch.Tensor:
        if self.embeddings is None:
            raise ValueError("call set_image() first")
        b = images.shape[0]
        latents = self.backend.encode_images(
            _resize_images(images, self.img_size) * 2.0 - 1.0)
        dev = latents.device
        with torch.no_grad():
            if step_ratio is not None:
                t = _anneal_t(step_ratio, self.backend.num_train_timesteps,
                              self.min_step, self.max_step, b, dev)
            else:
                t = samplers._draw_t(generator, b, self.min_step,
                                     self.max_step + 1, dev)
            a_t = self.backend.alphas[t][:, None, None, None]
            noise = samplers._draw_noise(generator, latents.shape, dev)
            noisy = torch.sqrt(a_t) * latents.detach() \
                + torch.sqrt(1 - a_t) * noise
            c, v = self._cond(b)
            cc = self.backend.cam_project(torch.cat(
                [c, self._cam_T(elevation, azimuth, radius,
                                default_elevation)], dim=-1))
            eps_hat = self._cfg_eps(noisy, t, cc, v, guidance_scale)
            grad = torch.nan_to_num((1.0 - a_t) * (eps_hat - noise))
        return _sds_loss(latents, grad, 1)

    @torch.no_grad()
    def refine(self, generator: torch.Generator, images: torch.Tensor,
               elevation, azimuth, radius, *, guidance_scale: float = 5.0,
               steps: int = 50, strength: float = 0.8,
               default_elevation: float = 0.0) -> torch.Tensor:
        """Full DDIM novel-view synthesis (ref::75-118). Keeps the
        reference's strength convention: start at timestep index
        int(steps*strength) of the descending list (i.e. strength
        close to 1 -> only the low-noise tail)."""
        if self.embeddings is None:
            raise ValueError("call set_image() first")
        b = images.shape[0]
        c, v = self._cond(b)
        dev = v.device
        alphas = self.backend.alphas
        ts = samplers.ddim_timesteps(self.backend.num_train_timesteps,
                                     steps)
        if strength == 0:
            init = 0
            latents = samplers._draw_noise(
                generator, (b, 4, self.latent_size, self.latent_size), dev)
        else:
            init = int(steps * strength)
            lat0 = self.backend.encode_images(
                _resize_images(images, self.img_size) * 2.0 - 1.0)
            latents = samplers.add_noise(
                alphas, lat0, samplers._draw_noise(generator, lat0.shape,
                                                   dev), int(ts[init]))
        cc = self.backend.cam_project(torch.cat(
            [c, self._cam_T(elevation, azimuth, radius, default_elevation)],
            dim=-1))
        ratio = self.backend.num_train_timesteps // steps
        for t in ts[init:]:
            t_in = torch.full((b,), int(t), dtype=torch.int32, device=dev)
            eps = self._cfg_eps(latents, t_in, cc, v, guidance_scale)
            latents = samplers.ddim_step(alphas, eps, int(t),
                                         int(t) - ratio, latents)
        return self.backend.decode_latents(latents)


def dilate_mask(mask: torch.Tensor, kernel: int = 3,
                iterations: int = 5) -> torch.Tensor:
    """Binary max-pool dilation, the role of cv2.dilate(k=3, iters=5) in
    the edit precompute (ref:gui/main_edit.py:320-395). mask (H, W);
    max_pool2d pads with -inf."""
    m = mask.to(torch.float32)[None, None]
    for _ in range(iterations):
        m = F.max_pool2d(m, kernel, stride=1, padding=kernel // 2)
    return m[0, 0] > 0.5
