"""The port's distillation trainer against goi_tpu's: the 4-term loss and
its gradients, the k-means codebook init, the optimizers' schedule and
rebudget, and whole train steps from one numpy state (goi_tpu with
backend='pallas' in interpret mode); plus the port's own copies of
tests/test_train.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goi_tpu.raster import RasterConfig as JConfig
from goi_tpu.raster import render as jrender
from goi_tpu.semantic.codebook import SemanticDecoder as JDecoder
from goi_tpu.semantic.codebook import init_codebook as j_init_codebook
from goi_tpu.semantic.codebook import kmeans as j_kmeans
from goi_tpu.semantic.losses import distillation_loss as j_loss
from goi_tpu.train.distill import create_distill_state as j_create
from goi_tpu.train.optim import OptimConfig as JOptim
from goi_tpu.train.optim import expon_lr_schedule as j_schedule
from goi_tpu.train.rgb import _rebudget as j_rebudget
from goi_tpu_torch import interop
from goi_tpu_torch.raster.render import RasterConfig
from goi_tpu_torch.semantic.codebook import (SemanticDecoder, init_codebook,
                                             kmeans)
from goi_tpu_torch.semantic.losses import distillation_loss
from goi_tpu_torch.train.distill import (_rebudget, create_distill_state,
                                         distill_loss, train_distillation)
from goi_tpu_torch.train.optim import (OptimConfig, expon_lr_schedule,
                                       make_scene_optimizer)
from tests.conftest import make_random_scene, make_test_camera
from tests.test_torch_core import to_torch_camera, to_torch_scene

torch.set_num_threads(1)

GRAD_TOL = dict(rtol=2e-3, atol=2e-4)
TERMS = ("lab", "sl", "sl1", "recc", "total")
ALL_ON = dict(position_finetune=True, feature_finetune=True,
              opacity_finetune=True, scaling_finetune=True,
              rotation_finetune=True, semantic_finetune=True)


def _decoder_to_torch(d):
    return interop.decoder_from_numpy(
        [np.asarray(w) for w in d.weights],
        [None if b is None else np.asarray(b) for b in d.biases],
        d.norm_output, device="cpu")


@pytest.mark.parametrize("anneal_t", [1.0, 2.0])
def test_distillation_loss_matches_goi_tpu(anneal_t):
    rng = np.random.default_rng(4)
    jdec = JDecoder.create(jax.random.PRNGKey(4), dim_in=10, dim_out=12)
    lut = rng.normal(0, 1, (12, 16)).astype(np.float32)
    lut[7] = lut[2]           # a duplicate code: tied similarities
    sem = rng.normal(0, 1, (500, 10)).astype(np.float32)
    gt = rng.normal(0, 1, (500, 16)).astype(np.float32)
    gt[3] = 0.0               # an all-zero feature row (the eps guard)

    def jf(dec, lut, sem):
        return j_loss(dec, lut, sem, jnp.asarray(gt), anneal_t)

    (jl, jaux), jg = jax.value_and_grad(jf, argnums=(0, 1, 2),
                                        has_aux=True)(
        jdec, jnp.asarray(lut), jnp.asarray(sem))
    tdec = _decoder_to_torch(jdec)
    tlut = torch.tensor(lut, requires_grad=True)
    tsem = torch.tensor(sem, requires_grad=True)
    tl, taux = distillation_loss(tdec, tlut, tsem, torch.as_tensor(gt),
                                 anneal_t)
    tl.backward()
    for k in TERMS:
        np.testing.assert_allclose(float(taux[k].detach()), float(jaux[k]),
                                   rtol=1e-5, err_msg=k)
    pairs = [(tdec.weights[0].grad, jg[0].weights[0]),
             (tdec.biases[0].grad, jg[0].biases[0]),
             (tlut.grad, jg[1]), (tsem.grad, jg[2])]
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-7)


def _match_up_to_order(a, b, tol):
    """Every row of a has a row of b within tol and vice versa."""
    d = np.abs(a[:, None, :] - b[None, :, :]).max(-1)
    assert d.min(1).max() < tol, d.min(1).max()
    assert d.min(0).max() < tol, d.min(0).max()


def test_kmeans_matches_goi_tpu():
    """Five tight clusters; the packages draw different initial centers,
    and this seed is one where both draws reach all five clusters (cosine
    k-means from random points can merge two clusters)."""
    rng = np.random.default_rng(1)
    protos = rng.normal(0, 1, (5, 32)).astype(np.float32)
    lab = rng.integers(0, 5, 600)
    x = protos[lab] + 0.02 * rng.normal(0, 1, (600, 32)).astype(np.float32)
    xn = x / np.linalg.norm(x, axis=1, keepdims=True)
    truth = np.stack([xn[lab == i].mean(0) for i in range(5)])
    want = np.asarray(j_kmeans(jax.random.PRNGKey(1), jnp.asarray(x), 5))
    got = kmeans(torch.Generator().manual_seed(1), torch.as_tensor(x),
                 5).numpy()
    _match_up_to_order(got, truth, 1e-5)
    _match_up_to_order(got, want, 1e-5)


def test_kmeans_keeps_every_point_when_k_covers_them():
    """n <= k: the (tiled) permutation puts a center on every point, so
    the result is the set of normalized points whatever the draw."""
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (7, 8)).astype(np.float32)
    xn = x / np.linalg.norm(x, axis=1, keepdims=True)
    for k in (7, 10):
        got = kmeans(torch.Generator().manual_seed(k), torch.as_tensor(x),
                     k).numpy()
        _match_up_to_order(got, xn, 1e-6)


def _prototype_maps(seed, n_maps, c=16, h=8, w=12, n_protos=4):
    """Feature maps laid out by a random label map over a few prototypes
    (a map has n_protos distinct pixels)."""
    rng = np.random.default_rng(seed)
    protos = rng.normal(0, 1, (6, c)).astype(np.float32)
    maps = []
    for i in range(n_maps):
        pick = protos[rng.choice(6, n_protos, replace=False)]
        lab = rng.integers(0, n_protos, (h, w))
        maps.append(np.ascontiguousarray(pick[lab].transpose(2, 0, 1)))
    return maps


@pytest.mark.parametrize("case", ["prototypes", "subsampled"])
def test_init_codebook_matches_goi_tpu(case):
    """Both levels see at most k distinct points, so the codebook is the
    set of (normalized) distinct features in either package; the
    subsampled case also pins default_rng(i).choice over the unique
    rows."""
    if case == "prototypes":
        maps = _prototype_maps(3, 2)
        kw = dict(tab_len=10, stride=1)
    else:
        rng = np.random.default_rng(5)
        maps = [rng.normal(0, 1, (8, 6, 9)).astype(np.float32)]
        kw = dict(tab_len=12, stride=1, max_points_per_image=10)
    want = np.asarray(j_init_codebook(jax.random.PRNGKey(0), maps, **kw))
    got = init_codebook(torch.Generator().manual_seed(0), maps, **kw)
    assert got.shape == want.shape
    _match_up_to_order(got.numpy(), want, 1e-5)


def test_unique_rows_match_numpy():
    """init_codebook's torch.unique(dim=0) gives np.unique(axis=0)'s rows
    in its order, which the subsample's indices refer to."""
    rng = np.random.default_rng(6)
    x = rng.integers(-3, 4, (400, 5)).astype(np.float32) * 0.5
    np.testing.assert_array_equal(torch.unique(torch.as_tensor(x),
                                               dim=0).numpy(),
                                  np.unique(x, axis=0))


def test_lr_schedule_and_optimizer_groups():
    cfg = OptimConfig(**ALL_ON)
    sched = expon_lr_schedule(1.6e-4, 1.6e-6, 30_000, lr_delay_mult=0.01)
    jsched = j_schedule(1.6e-4, 1.6e-6, 30_000, lr_delay_mult=0.01)
    for step in (0, 1, 500, 29_999, 40_000):
        np.testing.assert_allclose(sched(step), float(jsched(step)),
                                   rtol=1e-6)
    delayed = expon_lr_schedule(1e-2, 1e-4, 1000, lr_delay_steps=100,
                                lr_delay_mult=0.1)
    jdelayed = j_schedule(1e-2, 1e-4, 1000, lr_delay_steps=100,
                          lr_delay_mult=0.1)
    for step in (0, 50, 100, 700):
        np.testing.assert_allclose(delayed(step), float(jdelayed(step)),
                                   rtol=1e-6)
    params = to_torch_scene(make_random_scene(n=10, seed=0)).params()
    opt = make_scene_optimizer(cfg, 2.0, params)
    lrs = {g["name"]: g["lr"] for g in opt.param_groups}
    assert lrs["features_rest"] == pytest.approx(cfg.feature_lr / 20)
    assert lrs["xyz"] == pytest.approx(sched(0) * 2.0)
    assert all(g["eps"] == 1e-15 for g in opt.param_groups)
    assert make_scene_optimizer(OptimConfig(semantic_finetune=False), 1.0,
                                params) is None


def test_rebudget_matches_goi_tpu():
    for mi, slots, ninst in [(1 << 13, 9000, 8000), (4096, 100, 5000)]:
        got = _rebudget(RasterConfig(max_instances=mi), slots, ninst)
        want = j_rebudget(JConfig(max_instances=mi), slots, ninst)
        assert got.max_instances == want.max_instances


def _state_pair(cfg_kw):
    """One numpy state handed to both packages."""
    js = make_random_scene(n=200, seed=11, sem_dim=10)
    jc = make_test_camera(width=32, height=32)
    key = jax.random.PRNGKey(0)
    gt = np.array(jax.random.normal(key, (16, 32, 32)))
    jdec = JDecoder.create(key, dim_in=10, dim_out=8)
    lut = np.array(jax.random.normal(key, (8, 16))) * 0.1
    jstate, jstep = j_create(js, jdec, jnp.asarray(lut), JOptim(**cfg_kw))
    tstate, tstep = create_distill_state(
        to_torch_scene(js), _decoder_to_torch(jdec), torch.as_tensor(lut),
        OptimConfig(**cfg_kw))
    return (js, jc, jstate, jax.jit(jstep, static_argnames=("raster_cfg",)),
            to_torch_camera(jc), tstate, tstep, gt)


JCFG = JConfig(max_instances=1 << 13, backend="pallas")
TCFG = RasterConfig(max_instances=1 << 13)


def test_train_step_matches_goi_tpu():
    """Step 1's loss terms (rtol 1e-5) and gradients of every trained
    tensor (2e-3 / 2e-4), then the losses of 5 steps (rtol 1e-3: Adam's
    first step moves each parameter by lr * sign(g), so rounding-level
    gradients move parameters differently in the two packages)."""
    js, jc, jstate, jstep, tc, tstate, tstep, gt = _state_pair(ALL_ON)
    bg = np.zeros(3, np.float32)

    def jloss(params, dec, lut):
        out = jrender(js.with_params(params), jc, jnp.asarray(bg), JCFG)
        s, h, w = out["semantics"].shape
        return j_loss(dec, lut, out["semantics"].reshape(s, h * w).T,
                      jnp.asarray(gt).reshape(16, -1).T, 1.0)

    (_, jaux), (g_scene, g_dec, g_lut) = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(
        js.params(), jstate.decoder, jstate.lut)
    loss, taux = distill_loss(tstate, tc, torch.as_tensor(gt),
                              torch.as_tensor(bg), TCFG)
    loss.backward()
    for k in TERMS:
        np.testing.assert_allclose(float(taux[k].detach()), float(jaux[k]),
                                   rtol=1e-5, err_msg=k)
    got = dict(tstate.scene.params(), dec_w=tstate.decoder.weights[0],
               dec_b=tstate.decoder.biases[0], lut=tstate.lut)
    want = dict(g_scene, dec_w=g_dec.weights[0], dec_b=g_dec.biases[0],
                lut=g_lut)
    for k in want:
        np.testing.assert_allclose(got[k].grad.numpy(), np.asarray(want[k]),
                                   err_msg=k, **GRAD_TOL)

    jl, tl = [], []
    for _ in range(5):
        jstate, aux = jstep(jstate, jc, jnp.asarray(gt), jnp.asarray(bg),
                            JCFG)
        jl.append(float(aux["total"]))
        tstate, aux = tstep(tstate, tc, torch.as_tensor(gt),
                            torch.as_tensor(bg), TCFG)
        tl.append(float(aux["total"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert tstate.step == 5


def test_distillation_loss_decreases():
    """tests/test_train.py's mini train loop on the port."""
    js = make_random_scene(n=200, seed=11, sem_dim=10)
    scene = to_torch_scene(js)
    scene = scene.replace(semantics=torch.zeros_like(scene.semantics))
    cam = to_torch_camera(make_test_camera(width=32, height=32))
    gen = torch.Generator().manual_seed(0)
    ape_dim, k = 32, 8
    protos = torch.randn((2, ape_dim), generator=gen)
    left = (torch.arange(32) < 16)[None, None, :]
    gt = torch.where(left, protos[0][:, None, None],
                     protos[1][:, None, None]).expand(ape_dim, 32, 32)
    decoder = SemanticDecoder.create(gen, dim_in=10, dim_out=k,
                                     device="cpu")
    lut = torch.randn((k, ape_dim), generator=gen) * 0.1
    state, train_step = create_distill_state(
        scene, decoder, lut, OptimConfig(semantic_finetune=True))
    cfg = RasterConfig(max_instances=1 << 13)
    losses = []
    for _ in range(60):
        state, aux = train_step(state, cam, gt, torch.zeros(3), cfg)
        losses.append(float(aux["total"]))
    assert losses[-1] < losses[0] * 0.7, (losses[0], losses[-1])
    assert float(state.scene.semantics.abs().max()) > 1e-3
    assert float((state.lut - lut).abs().max()) > 1e-4
    # the caller's tensors are untouched
    assert not scene.semantics.any()


def test_optimizer_respects_finetune_flags():
    scene = to_torch_scene(make_random_scene(n=100, seed=12))
    cam = to_torch_camera(make_test_camera(width=32, height=32))
    gen = torch.Generator().manual_seed(1)
    decoder = SemanticDecoder.create(gen, dim_in=10, dim_out=8,
                                     device="cpu")
    lut = torch.randn((8, 16), generator=gen) * 0.1
    gt = torch.randn((16, 32, 32), generator=gen)
    state, train_step = create_distill_state(
        scene, decoder, lut, OptimConfig(semantic_finetune=True))
    state, _ = train_step(state, cam, gt, torch.zeros(3),
                          RasterConfig(max_instances=1 << 13))
    assert torch.equal(state.scene.xyz, scene.xyz)
    assert torch.equal(state.scene.opacity, scene.opacity)
    assert not torch.equal(state.scene.semantics, scene.semantics)
    assert not state.scene.xyz.requires_grad


def test_train_distillation_runs_and_rebudgets(capsys):
    js = make_random_scene(n=150, seed=13, sem_dim=10)
    scene = to_torch_scene(js)
    cams = [to_torch_camera(make_test_camera(width=32, height=32,
                                             angle=a)) for a in (0.1, 0.5)]
    maps = _prototype_maps(7, 2, c=16, h=32, w=32)
    seen = []
    state = train_distillation(
        scene, cams, maps, tab_len=6, iterations=4, log_every=1,
        raster_cfg=RasterConfig(max_instances=128),
        callback=lambda it, s, aux: seen.append(float(aux["total"])))
    out = capsys.readouterr().out
    assert "rebudgeting" in out and "iter 4, sem_loss" in out
    assert state.step == 4 and len(seen) == 4
    assert np.isfinite(seen).all()
    assert state.lut.shape == (6, 16)
