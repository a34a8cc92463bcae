"""The port's RGB trainer (goi_tpu_torch/train/rgb.py) against goi_tpu's:
one step from one numpy state carried across with interop (loss, L1,
the seven parameter gradients and the mean2d gradient, the densify
stats after add_stats), then the losses of 5 steps (goi_tpu with
backend='pallas' in interpret mode); the port's copy of
tests/test_rgb_densify.py::test_rgb_training_improves_psnr; and
train_rgb's host loop through a capacity overflow and an instance
budget overflow."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goi_tpu.eval.metrics import l1_loss as j_l1
from goi_tpu.eval.metrics import ssim as j_ssim
from goi_tpu.raster import RasterConfig as JConfig
from goi_tpu.raster import render as jrender
from goi_tpu.train.optim import OptimConfig as JOptim
from goi_tpu.train.rgb import create_rgb_trainer as j_trainer
from goi_tpu_torch import interop
from goi_tpu_torch.eval.metrics import psnr
from goi_tpu_torch.raster.render import RasterConfig, render
from goi_tpu_torch.train.densify import DensifyStats
from goi_tpu_torch.train.optim import OptimConfig
from goi_tpu_torch.train.rgb import create_rgb_trainer, rgb_loss, train_rgb
from tests.conftest import make_random_scene, make_test_camera
from tests.test_torch_core import to_torch_camera, to_torch_scene
from tests.test_torch_densify import _adam_groups
from tests.test_torch_train import GRAD_TOL

torch.set_num_threads(1)

JCFG = JConfig(max_instances=1 << 13, backend="pallas")
TCFG = RasterConfig(max_instances=1 << 13)
# tests/test_rgb_densify.py's learning rates
FAST = dict(position_lr_init=0.002, position_lr_final=0.0002,
            feature_lr=0.02, opacity_lr=0.05, scaling_lr=0.01,
            rotation_lr=0.005, lambda_dssim=0.2)


def _carry_state(jstate, init_fn):
    """The port's RGBTrainState holding goi_tpu's scene, Adam moments and
    counts, densify stats and step."""
    state = init_fn(to_torch_scene(jstate.scene))
    interop.adam_state_from_numpy(
        state.opt, _adam_groups(jstate.opt_state,
                                jstate.scene.PARAM_FIELDS))
    state.stats = DensifyStats(**{
        k: torch.tensor(np.asarray(getattr(jstate.stats, k)))
        for k in ("xyz_grad_accum", "denom", "max_radii")})
    state.step = int(jstate.step)
    return state


def test_rgb_step_matches_goi_tpu():
    """From goi_tpu's state after two steps: one step's loss and L1 (rtol
    1e-5), the gradients of the seven attributes and of mean2d
    (GRAD_TOL), the stats after add_stats, then the losses of 5 steps
    (rtol 1e-3: Adam moves a parameter by ~lr sign(g) at first, so
    rounding-level gradient differences move the packages apart)."""
    js = make_random_scene(n=150, seed=8)
    jc = make_test_camera(width=48, height=48, angle=0.2)
    target = make_random_scene(n=150, seed=9)
    bg = jnp.zeros(3)
    gt = jrender(target, jc, bg, JCFG)["render"]
    ocfg = dict(FAST, position_lr_max_steps=700)
    j_init, j_step_fn, _ = j_trainer(JOptim(**ocfg), JCFG)
    j_step = jax.jit(j_step_fn)
    jstate = j_init(js)
    for _ in range(2):
        jstate, _ = j_step(jstate, jc, gt, bg)

    init_fn, step_fn, _ = create_rgb_trainer(OptimConfig(**ocfg), TCFG)
    state = _carry_state(jstate, init_fn)
    tc, tgt, tbg = to_torch_camera(jc), torch.tensor(np.asarray(gt)), \
        torch.zeros(3)

    lam = FAST["lambda_dssim"]

    def jloss(params, off):
        out = jrender(jstate.scene.with_params(params), jc, bg, JCFG,
                      mean2d_offset=off)
        ll1 = j_l1(out["render"], gt)
        return (1 - lam) * ll1 + lam * (1 - j_ssim(out["render"], gt)), ll1

    (jl, jl1), (jg, jg_m2d) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
        jstate.scene.params(), jnp.zeros((js.capacity, 2)))
    offset = torch.zeros((js.capacity, 2), requires_grad=True)
    tl, aux = rgb_loss(state.scene, tc, tgt, tbg, TCFG, lam,
                       mean2d_offset=offset)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(aux["l1"].detach()), float(jl1),
                               rtol=1e-5)
    for k, p in state.scene.params().items():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg[k]),
                                   err_msg=k, **GRAD_TOL)
    np.testing.assert_allclose(offset.grad.numpy(), np.asarray(jg_m2d),
                               **GRAD_TOL)

    jstate, jaux = j_step(jstate, jc, gt, bg)
    state, taux = step_fn(state, tc, tgt, tbg)
    np.testing.assert_allclose(float(taux["loss"]), float(jaux["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(taux["gnorm"]), float(jaux["gnorm"]),
                               rtol=1e-4)
    assert int(taux["num_slots"]) == int(jaux["num_slots"])
    assert int(taux["radii_max"]) == int(jaux["radii_max"])
    np.testing.assert_array_equal(state.stats.denom.numpy(),
                                  np.asarray(jstate.stats.denom))
    np.testing.assert_array_equal(state.stats.max_radii.numpy(),
                                  np.asarray(jstate.stats.max_radii))
    np.testing.assert_allclose(state.stats.xyz_grad_accum.numpy(),
                               np.asarray(jstate.stats.xyz_grad_accum),
                               **GRAD_TOL)
    assert state.step == 3

    jl, tl = [], []
    for _ in range(5):
        jstate, jaux = j_step(jstate, jc, gt, bg)
        state, taux = step_fn(state, tc, tgt, tbg)
        jl.append(float(jaux["loss"]))
        tl.append(float(taux["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-3)


def test_rgb_training_improves_psnr():
    """tests/test_rgb_densify.py's case on the port: fit a fresh scene to
    three views of a target (+1.5 dB in 150 steps), then densify."""
    target = to_torch_scene(make_random_scene(n=150, seed=4))
    cams = [to_torch_camera(make_test_camera(width=48, height=48, angle=a))
            for a in (0.0, 0.5, -0.5)]
    bg = torch.zeros(3)
    with torch.no_grad():
        gts = [render(target, c, bg, TCFG)["render"] for c in cams]
    start = to_torch_scene(make_random_scene(n=150, seed=99, capacity=200))
    init_fn, step_fn, densify_fn = create_rgb_trainer(OptimConfig(**FAST),
                                                      TCFG)
    state = init_fn(start)
    with torch.no_grad():
        p0 = float(psnr(render(start, cams[0], bg, TCFG)["render"], gts[0]))
    rng = np.random.default_rng(0)
    for _ in range(150):
        ci = int(rng.integers(0, len(cams)))
        state, aux = step_fn(state, cams[ci], gts[ci], bg)
    with torch.no_grad():
        p1 = float(psnr(render(state.scene, cams[0], bg, TCFG)["render"],
                        gts[0]))
    assert p1 > p0 + 1.5, (p0, p1)

    # densify runs end to end on the trained state
    state2, info = densify_fn(state, torch.Generator().manual_seed(1),
                              extent=1.0)
    assert int(info["n_valid"]) >= 1
    with torch.no_grad():
        out = render(state2.scene, cams[0], bg, TCFG)
    assert torch.isfinite(out["render"]).all()


def test_train_rgb_grows_capacity_and_budget(capsys):
    """A scene with no free row and a budget far below its demand: the
    first densify overflows and grows the capacity, the slack check
    rebudgets, and return_raster_cfg hands back the grown config."""
    target = to_torch_scene(make_random_scene(n=120, seed=5))
    cams = [to_torch_camera(make_test_camera(width=32, height=32, angle=a))
            for a in (0.0, 0.4)]
    bg = torch.zeros(3)
    with torch.no_grad():
        gts = [render(target, c, bg, TCFG)["render"] for c in cams]
    start = to_torch_scene(make_random_scene(n=100, seed=6))
    ocfg = OptimConfig(iterations=12, densify_from_iter=2,
                       densification_interval=3, densify_until_iter=10,
                       opacity_reset_interval=9,
                       densify_grad_threshold=1e-7,
                       position_lr_max_steps=12)
    seen = []
    state, cfg = train_rgb(
        start, cams, gts, cfg=ocfg, iterations=12,
        raster_cfg=RasterConfig(max_instances=128), log_every=4,
        callback=lambda it, s, aux: seen.append(
            (it, s.scene.capacity, float(aux["loss"]),
             float(aux["gnorm"]))),
        return_raster_cfg=True)
    out = capsys.readouterr().out
    assert "densify overflow" in out and "growing capacity 100 -> 1124" \
        in out
    assert "rebudgeting" in out and "iter 12: loss" in out
    assert cfg.max_instances > 128
    assert [s[0] for s in seen] == list(range(1, 13))
    assert state.step == 12 and state.scene.capacity >= 1124
    assert np.isfinite([s[2:] for s in seen]).all()
    assert int(state.scene.num_valid) > 100
    # the caller's scene is untouched, the opacity reset ran at step 9
    assert start.capacity == 100
    with torch.no_grad():
        out = render(state.scene, cams[0], bg, cfg)
    assert int(out["num_slots"]) <= cfg.max_instances
    assert torch.isfinite(out["render"]).all()


@pytest.mark.parametrize("white", [False, True])
def test_train_rgb_takes_numpy_images(white):
    """Images as numpy arrays; the background follows white_background."""
    scene = to_torch_scene(make_random_scene(n=60, seed=7))
    cam = to_torch_camera(make_test_camera(width=24, height=24))
    img = np.full((3, 24, 24), 0.5, np.float32)
    state = train_rgb(scene, [cam], [img], iterations=3, log_every=100,
                      raster_cfg=TCFG, white_background=white)
    assert state.step == 3
    assert all(torch.isfinite(p).all() for p in state.scene.params().values())
