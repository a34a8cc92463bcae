"""goi_tpu_torch render (the blend kernel's plain version on the CPU)
against goi_tpu render(backend='pallas') in interpret mode and against
both oracles, at tests/test_pallas_blend.py's 5e-5 tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goi_tpu.raster import RasterConfig as JConfig
from goi_tpu.raster import pallas_blend as jpb
from goi_tpu.raster import render as jrender
from goi_tpu.raster.reference import render_reference as jref
from goi_tpu.raster.render import _effective_reduce as j_effective_reduce
from goi_tpu.raster.render import image_to_tiles as j_image_to_tiles
from goi_tpu.raster.render import suggest_budgets as j_suggest_budgets
from goi_tpu.raster.preprocess import preprocess as jpre
from goi_tpu_torch.raster import cuda_blend
from goi_tpu_torch.raster.blend import tiles_to_image
from goi_tpu_torch.raster.reference import render_reference as tref
from goi_tpu_torch.raster.render import (RasterConfig, _effective_reduce,
                                         image_to_tiles, render,
                                         suggest_budgets,
                                         suggest_instance_budget)
from tests.conftest import make_random_scene, make_test_camera
from tests.test_torch_core import to_torch_camera, to_torch_scene

torch.set_num_threads(1)

TOL = dict(rtol=5e-5, atol=5e-5)
JCFG = JConfig(max_instances=1 << 14, tile_cap=512, chunk=64,
               backend="pallas")
TCFG = RasterConfig(max_instances=1 << 14)
IMAGES = ("render", "semantics", "depth", "alpha")


def _close(a, b, key):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), err_msg=key,
                               **TOL)


@pytest.mark.parametrize("seed,n,wh", [
    (0, 300, (64, 48)),
    (2, 50, (40, 40)),
    (5, 1500, (32, 32)),      # tiles deeper than one K=256 chunk
])
def test_render_matches_pallas_and_oracles(seed, n, wh):
    js = make_random_scene(n=n, seed=seed)
    jc = make_test_camera(width=wh[0], height=wh[1], angle=0.2 * seed)
    ts, tc = to_torch_scene(js), to_torch_camera(jc)
    bg = np.ones(3, np.float32) if seed % 2 else np.zeros(3, np.float32)

    jout = jrender(js, jc, jnp.asarray(bg), JCFG)
    joracle = jref(js, jc, jnp.asarray(bg))
    tout = render(ts, tc, torch.as_tensor(bg), TCFG)
    toracle = tref(ts, tc, torch.as_tensor(bg))
    for k in IMAGES:
        assert tout[k].shape == tuple(jout[k].shape)
        _close(tout[k], jout[k], k)
        _close(tout[k], joracle[k], k)
        _close(tout[k], toracle[k], k)
        _close(toracle[k], joracle[k], k)
    for k in ("num_instances", "num_slots", "max_tile_depth", "radii",
              "visibility_filter"):
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]),
                                      k)
    if seed == 5:
        assert int(tout["max_tile_depth"]) > cuda_blend.K


def test_render_options_match_pallas():
    js = make_random_scene(n=200, seed=8, capacity=256)
    jc = make_test_camera(width=48, height=32, angle=0.4)
    ts, tc = to_torch_scene(js), to_torch_camera(jc)
    rng = np.random.default_rng(8)
    gmask = rng.uniform(0, 1, 256) > 0.3
    smask = (rng.uniform(0, 1, 256) > 0.5).astype(np.float32)
    off = rng.normal(0, 0.3, (256, 2)).astype(np.float32)
    bg = np.array([0.2, 0.5, 0.9], np.float32)
    jout = jrender(js, jc, jnp.asarray(bg), JCFG, scaling_modifier=0.8,
                   gaussian_mask=jnp.asarray(gmask),
                   semantic_masks=jnp.asarray(smask),
                   mean2d_offset=jnp.asarray(off))
    tout = render(ts, tc, torch.as_tensor(bg), TCFG, scaling_modifier=0.8,
                  gaussian_mask=torch.as_tensor(gmask),
                  semantic_masks=torch.as_tensor(smask),
                  mean2d_offset=torch.as_tensor(off))
    for k in IMAGES:
        _close(tout[k], jout[k], k)
    # the oracles take the same options (a mean2d offset moves the means
    # but not the preprocess rects, so the tiled path and the oracle
    # differ there by construction: compare like with like)
    jo = jrender(js, jc, jnp.asarray(bg), JConfig(backend="reference"),
                 scaling_modifier=0.8, gaussian_mask=jnp.asarray(gmask),
                 semantic_masks=jnp.asarray(smask),
                 mean2d_offset=jnp.asarray(off))
    to = render(ts, tc, torch.as_tensor(bg),
                RasterConfig(backend="reference"), scaling_modifier=0.8,
                gaussian_mask=torch.as_tensor(gmask),
                semantic_masks=torch.as_tensor(smask),
                mean2d_offset=torch.as_tensor(off))
    for k in IMAGES:
        _close(to[k], jo[k], k)


def test_pack_and_raw_blend_output():
    js = make_random_scene(n=300, seed=0)
    jc = make_test_camera()
    jsp = jpre(js, jc)
    gid = np.random.default_rng(0).integers(0, 300, 900).astype(np.int32)
    args = [np.array(jsp.mean2d), np.array(jsp.conic),
            np.array(jsp.opacity), np.array(jsp.color),
            np.array(jsp.semantics), np.array(jsp.depth), gid]
    want = np.asarray(jpb._pack_impl(*map(jnp.asarray, args)))
    got = cuda_blend.pack(*map(torch.as_tensor, args))
    assert got.shape == (20, 900)
    np.testing.assert_array_equal(got.numpy(), want[:20, :900])

    # raw kernel-layout output: sums, T, walked and blended counts
    ts, tc = to_torch_scene(js), to_torch_camera(jc)
    out = render(ts, tc, torch.zeros(3), TCFG)
    from goi_tpu_torch.raster.binning import bin_splats_chunked
    from goi_tpu_torch.raster.preprocess import preprocess
    sp = preprocess(ts, tc)
    b = bin_splats_chunked(sp, grid_x=4, grid_y=3, max_instances=1 << 14,
                           chunk_k=cuda_blend.K)
    feat = cuda_blend.pack(sp.mean2d, sp.conic, sp.opacity, sp.color,
                           sp.semantics, sp.depth, b.point_list)
    raw = cuda_blend.blend_fwd(feat, b.tile_start, b.tile_end, 4)
    assert raw.shape == (12, 256, 10 + 7)
    walked, blended = raw[..., 15], raw[..., 16]
    depth = (b.tile_end - b.tile_start).float()[:, None]
    assert (blended <= walked).all() and (walked <= depth).all()
    assert (blended > 0).any()
    alpha = tiles_to_image(1.0 - raw[..., 14:15], 4, 3, 48, 64)
    _close(alpha, out["alpha"], "alpha")


def test_config_budgets_and_layout_helpers():
    for mi in (1 << 14, 1 << 19, 1 << 21):
        for red in ("auto", "scatter", "chain"):
            assert _effective_reduce(RasterConfig(max_instances=mi,
                                                  reduce=red)) == \
                j_effective_reduce(JConfig(max_instances=mi, reduce=red,
                                           backend="pallas"))
    js = make_random_scene(n=300, seed=1)
    cams = [make_test_camera(angle=a) for a in (0.0, 0.6)]
    ts = to_torch_scene(js)
    tcams = [to_torch_camera(c) for c in cams]
    assert suggest_budgets(ts, tcams, margin=1.2, minimum=256) == \
        j_suggest_budgets(js, cams, margin=1.2, minimum=256, align=jpb.K)
    assert suggest_instance_budget(ts, tcams[0]) == 1 << 15
    img = np.random.default_rng(1).normal(0, 1, (5, 37, 50)) \
        .astype(np.float32)
    t = image_to_tiles(torch.as_tensor(img), 4, 3)
    np.testing.assert_array_equal(
        t.numpy(), np.asarray(j_image_to_tiles(jnp.asarray(img), 4, 3)))
    np.testing.assert_array_equal(tiles_to_image(t, 4, 3, 37, 50).numpy(),
                                  img)

    # the JAX package's TPU backend and its aligned layout's reduces are
    # not the port's
    for bad in (dict(backend="pallas"), dict(reduce="cumsum"),
                dict(reduce="sorted")):
        with pytest.raises(ValueError):
            render(ts, tcams[0], torch.zeros(3), RasterConfig(**bad))


def test_blend_backward_is_not_ported_yet():
    """The name dates from the first slice, when this pinned the missing
    backward; the blend backward is ported now, so it pins that the
    semantics' gradient flows and equals the oracle's (at
    tests/test_pallas_blend.py's gradient tolerance)."""
    js = make_random_scene(n=60, seed=2)
    tc = to_torch_camera(make_test_camera(32, 32))
    grads = []
    for cfg in (TCFG, RasterConfig(backend="reference")):
        ts = to_torch_scene(js)
        ts = ts.replace(semantics=ts.semantics.clone().requires_grad_(True))
        render(ts, tc, torch.zeros(3), cfg)["semantics"].sum().backward()
        grads.append(ts.semantics.grad.numpy())
    assert np.abs(grads[0]).max() > 0
    np.testing.assert_allclose(grads[0], grads[1], rtol=2e-3, atol=2e-4)
