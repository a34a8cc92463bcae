"""goi_tpu_torch's Stable-Diffusion UNet and VAE (guidance/sd_torch.py)
against the float64 golden and against goi_tpu's sd_jax: the UNet, the
VAE encode and the VAE decode at tests/test_sd_backend.py's TINY config
on the golden's seeded params (`_params_from_manifest`'s recipe), within
that test's tolerance, rtol 2e-4 and atol 2e-4 of the peak; the same
params through goi_tpu's unet_forward / vae_encode / vae_decode, and
goi_tpu's linear-layout init through interop.sd_from_numpy, at the same
tolerance; the full-size modules' state_dict against the golden's
manifest_full key for key and shape for shape (on the meta device); the
npz round trip, convert_diffusers_state, the alphas schedule,
conditioning that matters, and every parameter used."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goi_tpu.guidance import sd_jax
from goi_tpu_torch import interop
from goi_tpu_torch.guidance import sd_torch
from goi_tpu_torch.guidance.sd_torch import (AutoencoderKL, SDConfig,
                                             TorchDiffusionBackend,
                                             UNet2DCondition)
from tests.test_sd_backend import TINY as JTINY
from tests.test_sd_backend import _golden, _params_from_manifest

torch.set_num_threads(1)

TINY = SDConfig(**dataclasses.asdict(JTINY))
TOL = 2e-4          # tests/test_sd_backend.py: rtol, and atol of the peak


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())


@pytest.fixture(scope="module")
def golden():
    return _golden()


@pytest.fixture(scope="module")
def golden_params(golden):
    """The golden's fp32 params, unet and vae keys in one flat dict, as
    goi_tpu keeps them."""
    p = {k: np.asarray(v) for k, v in _params_from_manifest(
        golden["manifest_tiny"], "unet.", 100).items()}
    p.update({k: np.asarray(v) for k, v in _params_from_manifest(
        golden["manifest_tiny"], "vae.", 200).items()})
    return p


@pytest.fixture(scope="module")
def backend(golden_params):
    return interop.sd_from_numpy(golden_params, TINY, device="cpu")


def _unet_inputs(golden):
    i = golden["inputs"]
    return (np.asarray(i["sample"], np.float32), np.asarray(i["t"]),
            np.asarray(i["context"], np.float32))


def test_unet_matches_float64_golden(golden, backend):
    sample, t, ctx = _unet_inputs(golden)
    with torch.no_grad():
        eps = backend.unet_eps(torch.as_tensor(sample), torch.as_tensor(t),
                               torch.as_tensor(ctx))
    _close(eps.numpy(), golden["outputs"]["unet_eps"])


def test_vae_matches_float64_golden(golden, backend):
    img = np.asarray(golden["inputs"]["img"], np.float32)
    lat = np.asarray(golden["inputs"]["latents"], np.float32)
    with torch.no_grad():
        mean = backend.encode_images(torch.as_tensor(img)) \
            / TINY.scaling_factor
        dec = backend.vae.decode(torch.as_tensor(lat) * TINY.scaling_factor)
    _close(mean.numpy(), golden["outputs"]["vae_mean"])
    _close(dec.numpy(), golden["outputs"]["vae_decode"])


def _jax_outputs(params, sample, t, ctx, img, lat):
    p = {k: jnp.asarray(v) for k, v in params.items()}
    eps = jax.jit(lambda p, x, tt, c: sd_jax.unet_forward(p, JTINY, x, tt, c))(
        p, sample, t, ctx)
    enc = jax.jit(lambda p, x: sd_jax.vae_encode(p, JTINY, x))(p, img)
    dec = jax.jit(lambda p, z: sd_jax.vae_decode(p, JTINY, z))(p, lat)
    return [np.asarray(a) for a in (eps, enc, dec)]


def _torch_outputs(backend, sample, t, ctx, img, lat):
    with torch.no_grad():
        return [a.numpy() for a in (
            backend.unet_eps(torch.as_tensor(sample), torch.as_tensor(t),
                             torch.as_tensor(ctx)),
            backend.encode_images(torch.as_tensor(img)),
            backend.vae.decode(torch.as_tensor(lat)))]


@pytest.mark.parametrize("layout", ["conv_golden", "linear_init"])
def test_forwards_match_goi_tpu(golden, golden_params, layout):
    """The UNet, the VAE encode and the VAE decode of both packages on one
    params dict: the golden's (proj_in/out as 1x1 convs, the checkpoint's
    layout) or goi_tpu's init_sd_params (linear proj, reshaped by
    sd_from_numpy)."""
    if layout == "conv_golden":
        params = golden_params
    else:
        params = {k: np.asarray(v) for k, v in sd_jax.init_sd_params(
            jax.random.PRNGKey(3), JTINY).items()}
        assert params["down_blocks.0.attentions.0.proj_in.weight"].ndim == 2
    be = interop.sd_from_numpy(params, TINY, device="cpu")
    sample, t, ctx = _unet_inputs(golden)
    rng = np.random.default_rng(5)
    img = rng.uniform(-1, 1, (2, 3, 16, 16)).astype(np.float32)
    lat = rng.normal(0, 1, (2, 4, 8, 8)).astype(np.float32)
    want = _jax_outputs(params, sample, t, ctx, img, lat)
    got = _torch_outputs(be, sample, t, ctx, img, lat)
    for name, g, w in zip(("unet", "encode", "decode"), got, want):
        assert g.shape == w.shape, name
        assert np.abs(w).max() > 0, name
        _close(g, w)


def test_full_size_modules_match_the_manifest(golden):
    """runwayml/stable-diffusion-inpainting's geometry: the modules'
    state_dict keys and shapes are manifest_full's, the checkpoint's
    (proj_in/out 1x1 convs), 859,535,364 UNet and 83,653,863 VAE
    parameters."""
    full = SDConfig()
    unet = UNet2DCondition(full, device="meta")
    vae = AutoencoderKL(full, device="meta")
    ours = {"unet." + k: list(v.shape) for k, v in unet.state_dict().items()}
    ours.update({"vae." + k: list(v.shape)
                 for k, v in vae.state_dict().items()})
    assert ours == golden["manifest_full"]
    assert sum(p.numel() for p in unet.parameters()) == 859_535_364
    assert sum(p.numel() for p in vae.parameters()) == 83_653_863


def test_tiny_modules_match_the_tiny_manifest(golden):
    ours = {"unet." + k: list(v.shape) for k, v in
            UNet2DCondition(TINY, device="meta").state_dict().items()}
    ours.update({"vae." + k: list(v.shape) for k, v in
                 AutoencoderKL(TINY, device="meta").state_dict().items()})
    assert ours == golden["manifest_tiny"]


def test_sd_from_numpy_is_strict(golden_params):
    bad = dict(golden_params)
    bad["conv_in.extra"] = np.zeros(3, np.float32)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        interop.sd_from_numpy(bad, TINY, device="cpu")
    bad = dict(golden_params)
    del bad["encoder.conv_in.bias"]
    with pytest.raises(RuntimeError, match="Missing key"):
        interop.sd_from_numpy(bad, TINY, device="cpu")


def test_npz_round_trip_and_diffusers_state(tmp_path, golden_params,
                                            backend):
    """goi_tpu's params saved as .npz load through from_npz; the modules'
    own state dicts (diffusers names) go through convert_diffusers_state
    and load straight back."""
    path = os.path.join(tmp_path, "sd.npz")
    np.savez(path, **golden_params)
    be = TorchDiffusionBackend.from_npz(path, TINY, device="cpu")
    img = torch.full((1, 3, 32, 32), 0.25)
    with torch.no_grad():
        want = backend.encode_images(img)
        assert torch.equal(be.encode_images(img), want)
    flat = sd_torch.convert_diffusers_state(backend.unet.state_dict(),
                                            backend.vae.state_dict())
    assert set(flat) == set(golden_params)
    again = interop.sd_from_numpy(flat, TINY, device="cpu")
    unet = UNet2DCondition(TINY, device="cpu")
    unet.load_state_dict(backend.unet.state_dict(), strict=True)
    x = torch.randn(1, 9, 8, 8, generator=torch.Generator().manual_seed(0))
    t = torch.tensor([7])
    c = torch.randn(1, 7, 24, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ref = backend.unet_eps(x, t, c)
        assert torch.equal(again.unet_eps(x, t, c), ref)
        assert torch.equal(unet(x, t, c), ref)
        assert torch.equal(again.encode_images(img), want)


def test_alphas_schedule():
    a = sd_torch.alphas_cumprod(SDConfig(), device="cpu")
    want = np.asarray(sd_jax.alphas_cumprod(sd_jax.SDConfig()))
    assert a.shape == (1000,) and a.dtype == torch.float32
    assert float(a[0]) > 0.999 and float(a[-1]) < 0.01
    assert bool((torch.diff(a) < 0).all())
    np.testing.assert_allclose(a.numpy(), want, rtol=1e-5)
    # the angles reach 999 rad, whose float32 ulp is 6.1e-5: an ulp of a
    # frequency moves cos and sin by up to that much
    t = torch.tensor([0, 3, 999])
    np.testing.assert_allclose(
        sd_torch.timestep_embedding(t, 320).numpy(),
        np.asarray(sd_jax.timestep_embedding(jnp.asarray(t.numpy()), 320)),
        rtol=0, atol=2e-4)


def test_unet_conditioning_matters(backend):
    g = torch.Generator().manual_seed(2)
    x = torch.randn(1, 9, 16, 16, generator=g)
    c = torch.randn(1, 7, 24, generator=g)
    with torch.no_grad():
        e1 = backend.unet_eps(x, torch.tensor([10]), c)
        e2 = backend.unet_eps(x, torch.tensor([10]), c + 1.0)
        e3 = backend.unet_eps(x, torch.tensor([40]), c)
    assert float((e1 - e2).abs().max()) > 1e-6    # text cond used
    assert float((e1 - e3).abs().max()) > 1e-6    # timestep used


def test_every_parameter_used_and_seeded_init():
    """Every parameter of the UNet and the VAE takes a gradient from the
    UNet, the encode and the decode (none is left unread), and init_sd_
    follows goi_tpu's rule: biases 0, norm weights 1, other weights
    N(0, (0.1 / sqrt(fan_in))^2), the same draws from the same seed."""
    g = torch.Generator().manual_seed(0)
    unet = sd_torch.init_sd_(UNet2DCondition(TINY, device="cpu"), g)
    vae = sd_torch.init_sd_(AutoencoderKL(TINY, device="cpu"), g)
    params = dict(unet.named_parameters())
    assert not params["conv_in.bias"].any()
    assert torch.equal(params["conv_norm_out.weight"],
                       torch.ones_like(params["conv_norm_out.weight"]))
    w = params["mid_block.attentions.0.transformer_blocks.0.attn2.to_k.weight"]
    assert abs(float(w.detach().std()) * (24 ** 0.5) / 0.1 - 1) < 0.1
    again = sd_torch.init_sd_(UNet2DCondition(TINY, device="cpu"),
                              torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(unet.parameters(),
                                                 again.parameters()))

    x = torch.randn(2, 9, 8, 8, generator=g)
    c = torch.randn(2, 7, 24, generator=g)
    img = torch.rand(2, 3, 16, 16, generator=g) * 2 - 1
    eps = unet(x, torch.tensor([3, 40]), c)
    lat = vae.encode(img)
    dec = vae.decode(lat)
    assert eps.shape == (2, 4, 8, 8) and lat.shape == (2, 4, 8, 8)
    assert dec.shape == (2, 3, 16, 16)
    (eps.square().sum() + dec.square().sum()).backward()
    unused = [n for m in (unet, vae) for n, p in m.named_parameters()
              if p.grad is None or not p.grad.any()]
    assert not unused, unused[:8]


def test_vae_encode_samples_the_posterior_with_a_generator(backend):
    """encode(img, generator): mean + exp(0.5 clip(logvar, -30, 20)) *
    N(0, 1), scaled, as sd_jax.vae_encode with a sample_key."""
    img = torch.rand(1, 3, 16, 16,
                     generator=torch.Generator().manual_seed(3)) * 2 - 1
    with torch.no_grad():
        mean, logvar = backend.vae.quant_conv(
            backend.vae.encoder(img)).chunk(2, dim=1)
        got = backend.vae.encode(img, torch.Generator().manual_seed(9))
    noise = torch.randn(mean.shape,
                        generator=torch.Generator().manual_seed(9))
    want = (mean + torch.exp(0.5 * logvar.clamp(-30.0, 20.0)) * noise) \
        * TINY.scaling_factor
    assert torch.allclose(got, want, rtol=1e-6, atol=1e-7)
    assert not torch.allclose(got, mean * TINY.scaling_factor)


def test_backend_is_frozen_and_decodes_to_unit_range(backend):
    assert not any(p.requires_grad for p in backend.unet.parameters())
    assert not any(p.requires_grad for p in backend.vae.parameters())
    img = torch.rand(1, 3, 16, 16, requires_grad=True)
    lat = backend.encode_images(img * 2 - 1)
    lat.sum().backward()
    assert img.grad is not None and bool(img.grad.abs().max() > 0)
    with torch.no_grad():
        out = backend.decode_latents(lat.detach())
    assert out.shape == (1, 3, 16, 16)
    assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0
