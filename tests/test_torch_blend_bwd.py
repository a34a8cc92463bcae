"""The port's blend backward (the kernel's plain version on the CPU)
against the oracle's autograd and goi_tpu's Pallas backward in interpret
mode, at tests/test_pallas_blend.py's gradient tolerance (rtol 2e-3,
atol 2e-4: the suffix R_i = total - prefix_i cancels)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goi_tpu.raster import RasterConfig as JConfig
from goi_tpu.raster import render as jrender
from goi_tpu.raster.reference import render_reference as jref
from goi_tpu_torch.raster import cuda_blend
from goi_tpu_torch.raster.binning import bin_splats_chunked
from goi_tpu_torch.raster.preprocess import preprocess
from goi_tpu_torch.raster.reference import render_reference as tref
from goi_tpu_torch.raster.render import RasterConfig, render
from tests.conftest import make_random_scene, make_test_camera
from tests.test_torch_core import to_torch_camera, to_torch_scene

torch.set_num_threads(1)

GRAD_TOL = dict(rtol=2e-3, atol=2e-4)
NAMES = ("xyz", "semantics", "opacity", "scaling", "rotation",
         "features_dc")


def _targets(w, h, s):
    key = jax.random.PRNGKey(0)
    return (np.array(jax.random.normal(key, (3, h, w))),
            np.array(jax.random.normal(key, (s, h, w))))


def _jax_grads(js, jc, bg, render_fn, tgt_c, tgt_s):
    def f(*leaves):
        out = render_fn(js.replace(**dict(zip(NAMES, leaves))), jc)
        return (jnp.sum(out["render"] * tgt_c)
                + jnp.sum(out["semantics"] * tgt_s)
                + jnp.sum(out["depth"]) * 0.1
                + jnp.sum(out["alpha"]) * 0.1)
    args = tuple(getattr(js, k) for k in NAMES)
    return [np.asarray(g) for g in
            jax.grad(f, argnums=tuple(range(len(NAMES))))(*args)]


def _torch_grads(ts, tc, render_fn, tgt_c, tgt_s):
    leaves = {k: getattr(ts, k).clone().requires_grad_() for k in NAMES}
    out = render_fn(ts.replace(**leaves), tc)
    loss = ((out["render"] * torch.as_tensor(tgt_c)).sum()
            + (out["semantics"] * torch.as_tensor(tgt_s)).sum()
            + out["depth"].sum() * 0.1 + out["alpha"].sum() * 0.1)
    loss.backward()
    return [leaves[k].grad.numpy() for k in NAMES]


@pytest.mark.parametrize("reduce", ["scatter", "chain"])
@pytest.mark.parametrize("seed,n,wh", [
    (3, 120, (32, 32)),       # test_pallas_gradients_match_oracle's scene
    (5, 1500, (32, 32)),      # tiles deeper than one K=256 chunk
])
def test_render_gradients_match_oracle_and_pallas(reduce, seed, n, wh):
    js = make_random_scene(n=n, seed=seed)
    jc = make_test_camera(width=wh[0], height=wh[1])
    ts, tc = to_torch_scene(js), to_torch_camera(jc)
    tgt_c, tgt_s = _targets(*wh, js.sem_dim)
    bg = np.zeros(3, np.float32)
    cfg = RasterConfig(max_instances=1 << 14, reduce=reduce)
    port = _torch_grads(ts, tc, lambda s, c: render(
        s, c, torch.as_tensor(bg), cfg), tgt_c, tgt_s)
    oracle = _torch_grads(ts, tc, lambda s, c: tref(
        s, c, torch.as_tensor(bg)), tgt_c, tgt_s)
    jcfg = JConfig(max_instances=1 << 14, backend="pallas", reduce=reduce)
    pallas = _jax_grads(js, jc, bg, lambda s, c: jrender(
        s, c, jnp.asarray(bg), jcfg), tgt_c, tgt_s)
    for name, a, b, c in zip(NAMES, port, oracle, pallas):
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a, b, err_msg=f"{name} vs oracle",
                                   **GRAD_TOL)
        np.testing.assert_allclose(a, c, err_msg=f"{name} vs pallas",
                                   **GRAD_TOL)


def test_torch_oracle_gradients_match_jax_oracle():
    js = make_random_scene(n=120, seed=3)
    jc = make_test_camera(width=32, height=32)
    tgt_c, tgt_s = _targets(32, 32, js.sem_dim)
    bg = np.ones(3, np.float32)
    got = _torch_grads(to_torch_scene(js), to_torch_camera(jc),
                       lambda s, c: tref(s, c, torch.as_tensor(bg)),
                       tgt_c, tgt_s)
    want = _jax_grads(js, jc, bg, lambda s, c: jref(s, c, jnp.asarray(bg)),
                      tgt_c, tgt_s)
    for name, a, b in zip(NAMES, got, want):
        np.testing.assert_allclose(a, b, err_msg=name, **GRAD_TOL)


def _packed(seed, n, w, h, sem_dim, max_instances=1 << 15, spread=1.0):
    js = make_random_scene(n=n, seed=seed, sem_dim=sem_dim, spread=spread)
    ts = to_torch_scene(js)
    tc = to_torch_camera(make_test_camera(width=w, height=h))
    sp = preprocess(ts, tc)
    gx, gy = (w + 15) // 16, (h + 15) // 16
    b = bin_splats_chunked(sp, grid_x=gx, grid_y=gy,
                           max_instances=max_instances,
                           chunk_k=cuda_blend.K)
    feat = cuda_blend.pack(sp.mean2d, sp.conic, sp.opacity, sp.color,
                           sp.semantics, sp.depth, b.point_list)
    return feat, b, gx


@pytest.mark.parametrize("sem_dim", [0, 3, 10])
def test_blend_bwd_plain_is_the_forwards_vjp(sem_dim):
    """The plain backward's rows equal torch autograd through the plain
    forward (a different derivation of the same derivative: cumprod and
    clamp gradients instead of the suffix identity)."""
    feat, b, gx = _packed(7, 400, 48, 32, sem_dim)
    raw = cuda_blend.blend_fwd_plain(feat, b.tile_start, b.tile_end, gx)
    rng = np.random.default_rng(sem_dim)
    grad = torch.as_tensor(rng.normal(0, 1, raw.shape).astype(np.float32))
    grad[..., -2:] = 0.0      # the walked / blended counts
    rows = cuda_blend.blend_bwd_plain(feat, b.tile_start, b.tile_end, raw,
                                      grad, gx)
    f = feat.clone().requires_grad_()
    out = cuda_blend.blend_fwd_plain(f, b.tile_start, b.tile_end, gx)
    (out * grad).sum().backward()
    want = f.grad.T
    np.testing.assert_allclose(rows.numpy(), want.numpy(), **GRAD_TOL)
    # rows past the kept instances are zero
    kept = int(b.tile_end[-1])
    assert not rows[kept:].any()
    assert rows[:kept].abs().sum() > 0


def test_blend_bwd_plain_overflowed_budget():
    """A budget smaller than the demand: the rows of the truncated stream
    still equal the forward's VJP."""
    feat, b, gx = _packed(16, 300, 48, 32, 10, max_instances=256,
                          spread=0.3)
    assert int(b.num_slots) > 256
    raw = cuda_blend.blend_fwd_plain(feat, b.tile_start, b.tile_end, gx)
    grad = torch.ones_like(raw)
    grad[..., -2:] = 0.0
    rows = cuda_blend.blend_bwd_plain(feat, b.tile_start, b.tile_end, raw,
                                      grad, gx)
    f = feat.clone().requires_grad_()
    (cuda_blend.blend_fwd_plain(f, b.tile_start, b.tile_end, gx)
     * grad).sum().backward()
    np.testing.assert_allclose(rows.numpy(), f.grad.T.numpy(), **GRAD_TOL)


def test_backward_is_bitwise_repeatable():
    js = make_random_scene(n=300, seed=9)
    ts = to_torch_scene(js)
    tc = to_torch_camera(make_test_camera(width=48, height=32))
    cfg = RasterConfig(max_instances=1 << 13, reduce="chain")

    def grads():
        sem = ts.semantics.clone().requires_grad_()
        xyz = ts.xyz.clone().requires_grad_()
        out = render(ts.replace(semantics=sem, xyz=xyz), tc, torch.zeros(3),
                     cfg)
        (out["render"].square().sum() + out["semantics"].sum()).backward()
        return sem.grad, xyz.grad

    a, b = grads(), grads()
    for x, y in zip(a, b):
        assert torch.equal(x, y)
