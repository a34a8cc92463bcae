"""goi_tpu_torch's guidance (guidance/sds.py, guidance/samplers.py)
against goi_tpu's, the port fed goi_tpu's random draws (samplers'
_draw_noise / _draw_t / _draw_uniform replaced by the JAX key's draws,
split as goi_tpu splits it): InpaintSDS's loss and image gradient on the
analytic backend of tests/test_app_edit.py and on the tiny SD backend of
tests/test_sd_backend.py; PlainSDS, VSD, CDS
(tests/test_export_misc.py:85-170), LODSInpaintSDS and Zero123SDS
(tests/test_guidance_variants.py); dilate_mask torch.equal to goi_tpu's
on seeded masks; the DDIM samplers and inpaint_sample with injected
noise. Tolerances: losses rtol 1e-4 on the analytic backends (the same
float32 formulas, but resize_linear is held to jax.image.resize only at
1.5e-4 on [0, 1] images, tests/test_torch_sam_res.py, since JAX computes
its sample positions in float32; a constant image's latents shift by
~1e-5 of themselves, and the loss, their squared distance to a target,
by twice that) and 2e-4 through the tiny SD backend, as
tests/test_sd_backend.py holds that backend to its golden; gradients
rtol 1e-4 with atol 1e-5 of the peak on the analytic backends, 2e-4 of
the peak through SD."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goi_tpu.guidance import sd_jax
from goi_tpu.guidance import samplers as jsamplers
from goi_tpu.guidance import sds as jsds
from goi_tpu_torch import interop
from goi_tpu_torch.guidance import (CDS, VSD, InpaintSDS, LODSInpaintSDS,
                                    PlainSDS, SDXLInpaint, Zero123SDS,
                                    dilate_mask, inpaint_sample, samplers)
from goi_tpu_torch.guidance.sd_torch import SDConfig
from goi_tpu_torch.utils.image import resize_linear
from tests.test_app_edit import _ToyBackend as JToy
from tests.test_guidance_variants import _ToyInpaintBackend as JToyInpaint
from tests.test_guidance_variants import _ToyZero123Backend as JToyZero123
from tests.test_sd_backend import TINY as JTINY

torch.set_num_threads(1)

LOSS_RTOL = 1e-4
GRAD_TOL = (1e-4, 1e-5)     # rtol, atol of the peak (analytic backends)
SD_TOL = 2e-4               # tests/test_sd_backend.py's, of the peak


def _t(a):
    return torch.as_tensor(np.array(a))


def close_to_peak(got, want, rtol, atol_rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_rel * np.abs(want).max())


# ---- the analytic backends, as torch code ----

class ToyBackend:
    """tests/test_app_edit.py's _ToyBackend: identity 'vae' (resize to
    64x64, 4ch), eps pulling the latents toward a constant target color."""

    num_train_timesteps = 1000

    def __init__(self, target=0.8):
        self.alphas = _t(JToy(target).alphas)
        self.target = target

    def encode_images(self, imgs):
        b = imgs.shape[0]
        lat = resize_linear(imgs[:, :3], (b, 3, 64, 64))
        return torch.cat([lat, torch.zeros(b, 1, 64, 64)], dim=1)

    def unet_eps(self, latent_in, t, cond):
        noisy = latent_in[:, :4]
        a = self.alphas[t][:, None, None, None]
        tgt = torch.full_like(noisy, self.target * 2 - 1)
        tgt[:, 3] = 0.0
        return (noisy - torch.sqrt(a) * tgt) / torch.sqrt(1 - a)


class ToyInpaintBackend:
    """tests/test_guidance_variants.py's _ToyInpaintBackend."""

    num_train_timesteps = 1000
    scaling_factor = 1.0

    def __init__(self, target=0.8, latent=8):
        self.alphas = _t(JToyInpaint(target, latent).alphas)
        self.target = target
        self.ls = latent

    def encode_images(self, imgs):
        b = imgs.shape[0]
        return torch.cat([resize_linear(imgs[:, :3],
                                        (b, 3, self.ls, self.ls)),
                          torch.zeros(b, 1, self.ls, self.ls)], dim=1)

    def decode_latents(self, latents):
        b = latents.shape[0]
        img = resize_linear(latents[:, :3],
                            (b, 3, 8 * self.ls, 8 * self.ls))
        return torch.clamp(img / 2 + 0.5, 0.0, 1.0)

    def unet_eps(self, latent_in, t, cond):
        noisy = latent_in[:, :4]
        a = self.alphas[t][:, None, None, None]
        tgt = torch.full_like(noisy, self.target * 2 - 1)
        tgt[:, 3] = 0.0
        shift = torch.mean(cond, dim=(1, 2))[:, None, None, None]
        return (noisy - torch.sqrt(a) * (tgt + 0.0 * shift)) \
            / torch.sqrt(1 - a) + 0.01 * shift


class ToyZero123Backend(ToyInpaintBackend):
    def image_embed(self, imgs):
        b = imgs.shape[0]
        return torch.mean(imgs, dim=(2, 3))[:, None, :].repeat_interleave(
            4, 1).reshape(b, 1, -1)[:, :, :12]

    def cam_project(self, cc):
        if cc.shape[-1] >= 16:
            return cc[..., :16]
        return torch.nn.functional.pad(cc, (0, 16 - cc.shape[-1]))

    def unet_eps(self, latent_in, t, cond):
        noisy = latent_in[:, :4]
        a = self.alphas[t][:, None, None, None]
        tgt = torch.full_like(noisy, self.target * 2 - 1)
        return (noisy - torch.sqrt(a) * tgt) / torch.sqrt(1 - a) \
            + 0.01 * torch.mean(cond, dim=(1, 2))[:, None, None, None]


# ---- goi_tpu's draws, fed to the port ----

def inject(monkeypatch, noise=(), t=(), uniform=()):
    """Replace the port's draws with the given ones, in call order; each
    list must be used up by the test."""
    queues = {"noise": list(noise), "t": list(t), "uniform": list(uniform)}

    def take(kind):
        if not queues[kind]:
            raise AssertionError(f"an unexpected {kind} draw")
        return queues[kind].pop(0)

    def noise_fn(gen, shape, device):
        v = take("noise")
        assert tuple(v.shape) == tuple(shape)
        return _t(v).to(device)

    def t_fn(gen, batch, low, high, device):
        v = take("t")
        assert v.shape == (batch,) and low <= v.min() and v.max() < high
        return _t(v).long().to(device)

    def uniform_fn(gen, low, high, device):
        return torch.tensor(float(take("uniform")), device=device)

    monkeypatch.setattr(samplers, "_draw_noise", noise_fn)
    monkeypatch.setattr(samplers, "_draw_t", t_fn)
    monkeypatch.setattr(samplers, "_draw_uniform", uniform_fn)
    return queues


def sds_draws(key, shape, lo, hi):
    """goi_tpu's `key, kt, kn = split(key, 3)`: (t in [lo, hi), noise)."""
    _, kt, kn = jax.random.split(key, 3)
    return (np.asarray(jax.random.randint(kt, (shape[0],), lo, hi)),
            np.asarray(jax.random.normal(kn, shape, jnp.float32)))


def _images(b, h, w, seed):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (b, 3, h, w)).astype(np.float32)
    mask = np.zeros((b, 1, h, w), np.float32)
    mask[:, :, h // 5:h - h // 4, w // 7:w - w // 3] = 1.0
    return img, mask


def _jax_value_grad(fn, x):
    v, g = jax.value_and_grad(fn)(jnp.asarray(x))
    return float(v), np.asarray(g)


def _torch_value_grad(fn, x):
    xt = _t(x).clone().requires_grad_()
    v = fn(xt)
    v.backward()
    return float(v.detach()), xt.grad.numpy()


@pytest.mark.parametrize("step_ratio,gs", [(None, 7.5), (0.5, 1.0),
                                           (0.137, 100.0)])
def test_inpaint_sds_matches_goi_tpu_on_the_analytic_backend(
        monkeypatch, step_ratio, gs):
    """Loss and image gradient of one InpaintSDS step, batch 2 at 48x64
    (resized to 512, latents 64), random or annealed t."""
    jb, tb = JToy(0.9), ToyBackend(0.9)
    pos = np.random.default_rng(1).normal(0, 1, (4, 8)).astype(np.float32)
    js = jsds.InpaintSDS(jb, jnp.asarray(pos), jnp.zeros((4, 8)))
    ts = InpaintSDS(tb, _t(pos), torch.zeros(4, 8))
    img, mask = _images(2, 48, 64, 0)
    key = jax.random.PRNGKey(3)
    t, noise = sds_draws(key, (2, 4, 64, 64), js.min_step, js.max_step + 1)
    left = inject(monkeypatch, [noise], [] if step_ratio else [t])
    want = _jax_value_grad(lambda im: js.train_step(
        key, im, jnp.asarray(mask), step_ratio=step_ratio,
        guidance_scale=gs), img)
    got = _torch_value_grad(lambda im: ts.train_step(
        torch.Generator(), im, _t(mask), step_ratio=step_ratio,
        guidance_scale=gs), img)
    assert not any(left.values())
    np.testing.assert_allclose(got[0], want[0], rtol=LOSS_RTOL)
    assert want[0] > 0 and np.abs(want[1]).max() > 0
    close_to_peak(got[1], want[1], *GRAD_TOL)


def test_inpaint_sds_pulls_image_toward_target(monkeypatch):
    """tests/test_app_edit.py::test_sds_pulls_image_toward_target on the
    port: masked pixels brighten, no gradient outside the mask."""
    sds = InpaintSDS(ToyBackend(0.9), torch.zeros(1, 8), torch.zeros(1, 8))
    img = torch.full((1, 3, 64, 64), 0.2, requires_grad=True)
    mask = torch.zeros(1, 1, 64, 64)
    mask[:, :, :, :32] = 1.0
    sds.train_step(torch.Generator().manual_seed(0), img, mask,
                   step_ratio=0.5, guidance_scale=1.0).backward()
    g = img.grad.numpy()
    assert g[0, :, :, :32].mean() < -1e-6
    assert abs(g[0, :, :, 40:]).max() < 1e-6


@pytest.fixture(scope="module")
def tiny_sd():
    params = {k: np.asarray(v) for k, v in sd_jax.init_sd_params(
        jax.random.PRNGKey(4), JTINY).items()}
    return (sd_jax.JaxDiffusionBackend(params, JTINY),
            interop.sd_from_numpy(params, SDConfig(**dataclasses.asdict(
                JTINY)), device="cpu"))


@pytest.mark.parametrize("step_ratio", [None, 0.3])
def test_inpaint_sds_matches_goi_tpu_on_tiny_sd(monkeypatch, tiny_sd,
                                                step_ratio):
    """tests/test_sd_backend.py::test_inpaint_sds_with_jax_backend on
    both packages: loss and image gradient through the tiny UNet + VAE."""
    jb, tb = tiny_sd
    pos = np.full((7, 24), 0.1, np.float32)
    js = jsds.InpaintSDS(jb, jnp.asarray(pos), jnp.zeros((7, 24)),
                         latent_size=16, img_size=32)
    ts = InpaintSDS(tb, _t(pos), torch.zeros(7, 24), latent_size=16,
                    img_size=32)
    img = np.asarray(jax.random.uniform(jax.random.PRNGKey(5),
                                        (1, 3, 32, 32)))
    mask = np.zeros((1, 1, 32, 32), np.float32)
    mask[:, :, 8:24, 8:24] = 1.0
    key = jax.random.PRNGKey(6)
    t, noise = sds_draws(key, (1, 4, 16, 16), js.min_step, js.max_step + 1)
    inject(monkeypatch, [noise], [] if step_ratio else [t])
    want = _jax_value_grad(lambda im: js.train_step(
        key, im, jnp.asarray(mask), step_ratio=step_ratio,
        guidance_scale=4.0), img)
    got = _torch_value_grad(lambda im: ts.train_step(
        torch.Generator(), im, _t(mask), step_ratio=step_ratio,
        guidance_scale=4.0), img)
    np.testing.assert_allclose(got[0], want[0], rtol=SD_TOL)
    assert np.isfinite(want[1]).all() and np.abs(want[1]).max() > 0
    close_to_peak(got[1], want[1], SD_TOL, SD_TOL)


def test_plain_sds_matches_goi_tpu(monkeypatch):
    """tests/test_export_misc.py::test_plain_sds: the gradient brightens
    the render, and equals goi_tpu's."""
    jb, tb = JToy(0.9), ToyBackend(0.9)
    js = jsds.PlainSDS(jb, jnp.zeros((1, 8)), jnp.zeros((1, 8)))
    ts = PlainSDS(tb, torch.zeros(1, 8), torch.zeros(1, 8))
    img = np.full((1, 3, 64, 64), 0.2, np.float32)
    key = jax.random.PRNGKey(0)
    _, noise = sds_draws(key, (1, 4, 64, 64), 0, 1)
    inject(monkeypatch, [noise])
    want = _jax_value_grad(lambda im: js.train_step(
        key, im, step_ratio=0.5, guidance_scale=1.0), img)
    got = _torch_value_grad(lambda im: ts.train_step(
        torch.Generator(), im, step_ratio=0.5, guidance_scale=1.0), img)
    assert got[1].mean() < 0
    np.testing.assert_allclose(got[0], want[0], rtol=LOSS_RTOL)
    close_to_peak(got[1], want[1], *GRAD_TOL)


def test_vsd_and_cds_match_goi_tpu(monkeypatch):
    """tests/test_export_misc.py::test_vsd_and_cds on both packages: VSD's
    render gradient ascends toward the pretrained target, its particle
    loss differentiates w.r.t. the LoRA params; CDS's loss and gradient
    are finite; each equals goi_tpu's."""
    jb, tb = JToy(0.9), ToyBackend(0.9)

    def j_lora(params, noisy, t, cond):
        a = jb.alphas[t][:, None, None, None]
        return (noisy - jnp.sqrt(a) * jnp.full_like(noisy, params["x0"])) \
            / jnp.sqrt(1 - a)

    def t_lora(params, noisy, t, cond):
        a = tb.alphas[t][:, None, None, None]
        return (noisy - torch.sqrt(a) * params["x0"]) / torch.sqrt(1 - a)

    jv = jsds.VSD(jb, j_lora, jnp.zeros((1, 8)), jnp.zeros((1, 8)))
    tv = VSD(tb, t_lora, torch.zeros(1, 8), torch.zeros(1, 8))
    img = np.full((1, 3, 64, 64), 0.2, np.float32)
    key = jax.random.PRNGKey(0)
    jparams = {"x0": jnp.asarray(0.2 * 2 - 1)}
    tparams = {"x0": torch.tensor(0.2 * 2 - 1, requires_grad=True)}
    t, noise = sds_draws(key, (1, 4, 64, 64), jv._s.min_step,
                         jv._s.max_step + 1)

    inject(monkeypatch, [noise])
    want = _jax_value_grad(lambda im: jv.train_step(
        key, jparams, im, step_ratio=0.5, guidance_scale=1.0), img)
    got = _torch_value_grad(lambda im: tv.train_step(
        torch.Generator(), tparams, im, step_ratio=0.5,
        guidance_scale=1.0), img)
    assert got[1].mean() < 0
    np.testing.assert_allclose(got[0], want[0], rtol=LOSS_RTOL)
    close_to_peak(got[1], want[1], *GRAD_TOL)

    inject(monkeypatch, [noise], [t])
    jl, jg = jax.value_and_grad(lambda p: jv.lora_loss(key, p, img))(
        jparams)
    tl = tv.lora_loss(torch.Generator(), tparams, _t(img))
    tl.backward()
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tparams["x0"].grad), float(jg["x0"]),
                               rtol=GRAD_TOL[0])

    jc = jsds.CDS(jb, jnp.zeros((1, 8)), jnp.zeros((1, 8)))
    tc = CDS(tb, torch.zeros(1, 8), torch.zeros(1, 8))
    _, ku, kn = jax.random.split(key, 3)
    u = float(jax.random.uniform(ku, (), minval=0.1, maxval=0.2))
    cnoise = np.asarray(jax.random.normal(kn, (1, 4, 64, 64), jnp.float32))
    inject(monkeypatch, [cnoise], uniform=[u])
    want = _jax_value_grad(lambda im: jc.train_step(
        key, im, step_ratio=0.5, guidance_scale=1.0), img)
    got = _torch_value_grad(lambda im: tc.train_step(
        torch.Generator(), im, step_ratio=0.5, guidance_scale=1.0), img)
    assert np.isfinite(got[0]) and np.isfinite(got[1]).all()
    np.testing.assert_allclose(got[0], want[0], rtol=LOSS_RTOL)
    close_to_peak(got[1], want[1], *GRAD_TOL)


def test_lods_losses_match_goi_tpu(monkeypatch):
    """tests/test_guidance_variants.py::test_lods_sds_and_embedding_losses
    on both packages: the brightness gradient of sds_loss (negative: pull
    toward 0.9) and the embedding loss's gradient w.r.t. the learnable
    unconditional embedding; the anneal's end points."""
    jb, tb = JToyInpaint(0.9), ToyInpaintBackend(0.9)
    neg = np.full((4, 16), 0.1, np.float32)
    jl = jsds.LODSInpaintSDS(jb, jnp.zeros((4, 16)), jnp.asarray(neg),
                             latent_size=8, img_size=64)
    tl = LODSInpaintSDS(tb, torch.zeros(4, 16), _t(neg), latent_size=8,
                        img_size=64)
    unc = tl.init_uncond()
    assert torch.equal(unc, _t(neg))
    mask = np.ones((2, 1, 32, 32), np.float32)
    key = jax.random.PRNGKey(0)
    _, noise = sds_draws(key, (2, 4, 8, 8), 0, 1)

    inject(monkeypatch, [noise])
    jg = float(jax.grad(lambda v: jl.sds_loss(
        key, jnp.asarray(neg), jnp.full((2, 3, 32, 32), v),
        jnp.asarray(mask), step_ratio=0.5, guidance_scale=7.5))(0.2))
    v = torch.tensor(0.2, requires_grad=True)
    tl.sds_loss(torch.Generator(), unc, v * torch.ones(2, 3, 32, 32),
                _t(mask), step_ratio=0.5, guidance_scale=7.5).backward()
    assert float(v.grad) < 0 and jg < 0
    np.testing.assert_allclose(float(v.grad), jg, rtol=GRAD_TOL[0])

    img = np.full((2, 3, 32, 32), 0.2, np.float32)
    k1 = jax.random.PRNGKey(1)
    t, noise = sds_draws(k1, (2, 4, 8, 8), 0, 1000)
    inject(monkeypatch, [noise], [t])
    jv, jgrad = jax.value_and_grad(lambda u: jl.embedding_loss(
        k1, u, jnp.asarray(img), jnp.asarray(mask)))(jnp.asarray(neg))
    u = unc.clone().requires_grad_()
    tv = tl.embedding_loss(torch.Generator(), u, _t(img), _t(mask))
    tv.backward()
    np.testing.assert_allclose(float(tv), float(jv), rtol=LOSS_RTOL)
    assert np.abs(np.asarray(jgrad)).max() > 0
    close_to_peak(u.grad.numpy(), jgrad, *GRAD_TOL)

    s = tl._s
    for sr, expect in [(0.0, s.max_step), (1.0, s.min_step)]:
        inject(monkeypatch, [noise])
        with torch.no_grad():
            got_t = []
            orig = tb.unet_eps
            tb.unet_eps = lambda x, t, c: (got_t.append(t), orig(x, t, c))[1]
            try:
                tl.sds_loss(torch.Generator(), unc, _t(img), _t(mask),
                            step_ratio=sr)
            finally:
                tb.unet_eps = orig
        assert all(int(t_) == expect for tt in got_t for t_ in tt)


def test_zero123_matches_goi_tpu(monkeypatch):
    """tests/test_guidance_variants.py::test_zero123_train_step_and_refine
    on both packages: the train step's gradient (negative: pull a dark
    render toward 0.5), refine's DDIM output, the stable camera term."""
    jb, tb = JToyZero123(0.5), ToyZero123Backend(0.5)
    jz = jsds.Zero123SDS(jb, latent_size=8, img_size=64)
    tz = Zero123SDS(tb, latent_size=8, img_size=64)
    ref = np.full((1, 3, 64, 64), 0.5, np.float32)
    jz.set_image(jnp.asarray(ref))
    tz.set_image(_t(ref))
    for a, b in zip(tz.embeddings, jz.embeddings):
        close_to_peak(a.numpy(), b, 1e-6, 1e-7)

    key = jax.random.PRNGKey(0)
    _, noise = sds_draws(key, (1, 4, 8, 8), 0, 1)
    inject(monkeypatch, [noise])
    jg = float(jax.grad(lambda v: jz.train_step(
        key, jnp.full((1, 3, 64, 64), v), [10.0], [30.0], [0.0],
        step_ratio=0.5, guidance_scale=5.0))(0.1))
    v = torch.tensor(0.1, requires_grad=True)
    tz.train_step(torch.Generator(), v * torch.ones(1, 3, 64, 64), [10.0],
                  [30.0], [0.0], step_ratio=0.5,
                  guidance_scale=5.0).backward()
    assert float(v.grad) < 0
    np.testing.assert_allclose(float(v.grad), jg, rtol=GRAD_TOL[0])

    k1 = jax.random.PRNGKey(1)
    _, kn = jax.random.split(k1)
    inject(monkeypatch, [np.asarray(jax.random.normal(kn, (1, 4, 8, 8)))])
    want = np.asarray(jz.refine(k1, jnp.asarray(ref), [0.0], [45.0], [0.0],
                                steps=10, strength=0.5))
    got = tz.refine(torch.Generator(), _t(ref), [0.0], [45.0], [0.0],
                    steps=10, strength=0.5)
    assert got.shape == (1, 3, 64, 64)
    assert abs(float(got.mean()) - 0.5) < 0.1
    close_to_peak(got.numpy(), want, 1e-4, 1e-5)

    zs = Zero123SDS(tb, latent_size=8, img_size=64, stable=True)
    zs.set_image(_t(ref))
    T = zs._cam_T([10.0], [30.0], [0.5], default_elevation=0.0)
    np.testing.assert_allclose(float(T[0, 0, 3]), np.deg2rad(90.0),
                               atol=1e-6)
    with pytest.raises(ValueError, match="set_image"):
        Zero123SDS(tb).train_step(torch.Generator(), _t(ref), [0.0], [0.0],
                                  [0.0])


@pytest.mark.parametrize("shape,p,kernel,iters", [
    ((16, 16), 0.0, 3, 2), ((37, 53), 0.01, 3, 5), ((64, 48), 0.002, 5, 3),
    ((968 // 8, 1296 // 8), 0.001, 3, 5)])
def test_dilate_mask_equals_goi_tpu(shape, p, kernel, iters):
    rng = np.random.default_rng(int(np.prod(shape)))
    m = rng.uniform(0, 1, shape) < p
    m[0, -1] = m[shape[0] // 2, shape[1] // 2] = True   # an edge and a core
    got = dilate_mask(torch.as_tensor(m), kernel=kernel, iterations=iters)
    want = np.asarray(jsds.dilate_mask(jnp.asarray(m), kernel=kernel,
                                       iterations=iters))
    assert got.dtype == torch.bool
    assert torch.equal(got, torch.as_tensor(want))
    one = torch.zeros(16, 16, dtype=torch.bool)
    one[8, 8] = True
    assert int(dilate_mask(one, 3, 2).sum()) == 25     # a 5x5 square


def test_ddim_samplers_match_goi_tpu():
    """tests/test_guidance_variants.py's DDIM checks on the port: leading
    spacing, add_noise, one DDIM step back to x0 with the exact eps."""
    ts = samplers.ddim_timesteps(1000, 50)
    assert len(ts) == 50 and ts[0] == 981 and ts[-1] == 1
    assert np.array_equal(ts, jsamplers.ddim_timesteps(1000, 50))
    be = ToyInpaintBackend()
    x0 = torch.full((1, 4, 8, 8), 0.3)
    noise = torch.randn(x0.shape, generator=torch.Generator().manual_seed(0))
    xt = samplers.add_noise(be.alphas, x0, noise, 600)
    want = jsamplers.add_noise(jnp.asarray(be.alphas.numpy()),
                               jnp.asarray(x0.numpy()),
                               jnp.asarray(noise.numpy()), 600)
    np.testing.assert_allclose(xt.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(
        samplers.ddim_step(be.alphas, noise, 600, -1, xt).numpy(),
        x0.numpy(), atol=1e-5)
    j = jsamplers.ddim_step(jnp.asarray(be.alphas.numpy()),
                            jnp.asarray(noise.numpy()), 600, 580,
                            jnp.asarray(xt.numpy()))
    np.testing.assert_allclose(
        samplers.ddim_step(be.alphas, noise, 600, 580, xt).numpy(),
        np.asarray(j), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("strength", [1.0, 0.5])
def test_inpaint_sample_matches_goi_tpu(monkeypatch, strength):
    """tests/test_guidance_variants.py::test_inpaint_sample_reaches_target
    on both packages with goi_tpu's noise: the same image, on the analytic
    target color."""
    jb, tb = JToyInpaint(0.7), ToyInpaintBackend(0.7)
    img = np.full((1, 3, 64, 64), 0.2, np.float32)
    img[:, 1] = 0.4
    mask = np.ones((1, 1, 64, 64), np.float32)
    pos = np.zeros((4, 16), np.float32)
    key = jax.random.PRNGKey(0)
    _, kn = jax.random.split(key)
    inject(monkeypatch, [np.asarray(jax.random.normal(kn, (1, 4, 8, 8)))])
    want = np.asarray(jsamplers.inpaint_sample(
        jb, jnp.asarray(pos), jnp.asarray(pos), jnp.asarray(img),
        jnp.asarray(mask), key=key, num_steps=25, guidance_scale=1.0,
        strength=strength, img_size=64))
    got = inpaint_sample(tb, _t(pos), _t(pos), _t(img), _t(mask),
                         generator=torch.Generator(), num_steps=25,
                         guidance_scale=1.0, strength=strength, img_size=64)
    assert got.shape == (1, 3, 64, 64)
    close_to_peak(got.numpy(), want, 1e-4, 1e-5)
    if strength == 1.0:
        assert abs(float(got.mean()) - 0.7) < 0.05


def test_sdxl_inpaint_wrapper_matches_goi_tpu(monkeypatch):
    jb, tb = JToyInpaint(0.6, 8), ToyInpaintBackend(0.6, 8)
    key = jax.random.PRNGKey(1)
    _, kn = jax.random.split(key)
    inject(monkeypatch, [np.asarray(jax.random.normal(kn, (1, 4, 8, 8)))])
    js = jsamplers.SDXLInpaint(jb, jnp.zeros((4, 16)), jnp.zeros((4, 16)),
                               img_size=64)
    ts = SDXLInpaint(tb, torch.zeros(4, 16), torch.zeros(4, 16),
                     img_size=64)
    img = np.full((1, 3, 32, 32), 0.1, np.float32)
    mask = np.ones((1, 1, 32, 32), np.float32)
    want = np.asarray(js.inpaint(key, jnp.asarray(img), jnp.asarray(mask),
                                 num_inference_steps=20, strength=0.99,
                                 guidance_scale=1.0))
    got = ts.inpaint(torch.Generator(), _t(img), _t(mask),
                     num_inference_steps=20, strength=0.99,
                     guidance_scale=1.0)
    assert got.shape == (1, 3, 64, 64)
    assert abs(float(got.mean()) - 0.6) < 0.08
    close_to_peak(got.numpy(), want, 1e-4, 1e-5)


def test_draw_helpers_are_seeded():
    """The default draws: the same generator seed gives the same draws,
    in range."""
    def draws(seed):
        g = torch.Generator().manual_seed(seed)
        return (samplers._draw_noise(g, (2, 3), "cpu"),
                samplers._draw_t(g, 5, 20, 981, "cpu"),
                samplers._draw_uniform(g, 0.1, 0.2, "cpu"))
    a, b = draws(0), draws(0)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert a[1].dtype == torch.int64 and 20 <= int(a[1].min())
    assert int(a[1].max()) < 981
    assert 0.1 <= float(a[2]) < 0.2 and a[2].dtype == torch.float32
