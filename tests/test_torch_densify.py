"""The port's densification (goi_tpu_torch/train/densify.py) against
goi_tpu's: clone / split / prune on one numpy state, fed the JAX split
draws, bit-exact on the integer and bool outputs and the moments, at
rtol 1e-6 (with an ulp-scale floor) on the floats; the Adam-state
surgery on torch.optim.Adam; capacity growth
and the opacity reset; plus the port's copies of
tests/test_rgb_densify.py::test_densify_clone_split_prune and
tests/test_advisor_fixes.py's two densify tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goi_tpu.core.scene import GaussianScene as JScene
from goi_tpu.raster import RasterConfig as JConfig
from goi_tpu.train import densify as jdensify
from goi_tpu.train.optim import OptimConfig as JOptim
from goi_tpu.train.rgb import create_rgb_trainer as j_trainer
from goi_tpu_torch import interop
from goi_tpu_torch.core.scene import GaussianScene
from goi_tpu_torch.train import densify
from goi_tpu_torch.train.densify import (DensifyStats, densify_and_prune,
                                         grow_capacity, reset_opacity)
from goi_tpu_torch.train.optim import (OptimConfig,
                                       make_full_training_optimizer)
from tests.conftest import make_random_scene, make_test_camera
from tests.test_torch_core import to_torch_scene

torch.set_num_threads(1)

# rtol 1e-6, and an absolute floor at the ulp scale of the split offsets:
# exp (the scales) and the quaternion normalisation differ by an ulp
# between the packages, which moves a child's xyz by ~2e-8, above rtol
# alone where the child lies near a coordinate plane
FLOAT_TOL = dict(rtol=1e-6, atol=1e-7)
INFO_KEYS = ("n_clone", "n_split", "n_pruned", "n_valid", "overflow")


def _adam_with_moments(params: dict, mu: float, nu: float, step: float):
    """A torch Adam over `params` whose every row has the given moments."""
    opt = torch.optim.Adam(list(params.values()), lr=1e-3, eps=1e-15)
    for p in params.values():
        opt.state[p] = {"step": torch.tensor(step),
                        "exp_avg": torch.full_like(p, mu),
                        "exp_avg_sq": torch.full_like(p, nu)}
    return opt


def _leaves(scene: GaussianScene) -> dict:
    return {k: v.detach().clone().requires_grad_()
            for k, v in scene.params().items()}


def test_densify_clone_split_prune():
    """tests/test_rgb_densify.py's case: 25 clones, 25 splits, 150 valid,
    the written rows' moments zeroed and the others untouched."""
    js = make_random_scene(n=100, seed=0, capacity=300)
    scaling = np.asarray(js.scaling).copy()
    scaling[:25] = -8.0   # tiny -> clone
    scaling[25:50] = 1.0  # huge -> split
    scene = to_torch_scene(js.replace(scaling=jnp.asarray(scaling)))
    cap = scene.capacity
    scene = scene.with_params(_leaves(scene))
    opt = _adam_with_moments({"xyz": scene.xyz}, 1.0, 1.0, 3.0)
    stats = DensifyStats(
        xyz_grad_accum=torch.where(torch.arange(cap) < 50, 1.0, 0.0),
        denom=torch.ones(cap), max_radii=torch.zeros(cap, dtype=torch.int32))
    new_scene, new_opt, new_stats, info = densify_and_prune(
        scene, opt, stats, torch.Generator().manual_seed(0),
        grad_threshold=0.5, min_opacity=1e-9, extent=1.0,
        percent_dense=0.01)
    assert int(info["n_clone"]) == 25
    assert int(info["n_split"]) == 25
    # 100 valid + 25 clones + 50 children - 25 split parents = 150
    assert int(info["n_valid"]) == 150
    assert int(info["overflow"]) == 0
    mu = new_opt.state[new_scene.xyz]["exp_avg"]
    assert float(mu[:100].sum()) == 300.0
    written = new_scene.valid.clone()
    written[:100] = False
    assert int(written.sum()) == 75
    assert not mu[written].any()
    assert new_opt.state[new_scene.xyz]["step"] == 3.0
    # the rows went into the optimizer's own tensor, and the stats restart
    assert new_scene.xyz is scene.xyz
    assert not new_stats.denom.any()


def _split_scene(n, seed):
    rng = np.random.default_rng(seed)
    xyz = rng.normal(0, 1, (n, 3)).astype(np.float32)
    return JScene.create(xyz, None, sh_degree=0, sem_dim=4,
                         scales=np.full(n, 0.5, np.float32))  # all split


def _hot_stats(n):
    return DensifyStats(xyz_grad_accum=torch.full((n,), 10.0),
                        denom=torch.ones(n),
                        max_radii=torch.zeros(n, dtype=torch.int32))


def test_densify_overflow_keeps_split_parents():
    """At zero free capacity a split's children are dropped; the parent
    survives the prune (tests/test_advisor_fixes.py's case)."""
    n = 64
    scene = to_torch_scene(_split_scene(n, 5))
    scene = scene.with_params(_leaves(scene))
    new_scene, _, _, info = densify_and_prune(
        scene, None, _hot_stats(n), torch.Generator().manual_seed(0),
        grad_threshold=1e-4, min_opacity=0.005, extent=1.0,
        percent_dense=0.01)
    assert int(info["overflow"]) > 0
    assert int(info["n_split"]) == n
    assert int(new_scene.num_valid) == n
    # nothing was written
    assert torch.equal(new_scene.xyz, scene.xyz)


def test_grow_capacity_then_densify():
    """tests/test_advisor_fixes.py's case on a torch Adam: the padded
    rows are invalid with zero moments, the step count is kept, the
    optimizer holds the new tensors, and a densify then has room."""
    n = 32
    scene = to_torch_scene(_split_scene(n, 6))
    scene = scene.with_params(_leaves(scene))
    opt = make_full_training_optimizer(OptimConfig(), 1.0, scene.params())
    for p in scene.params().values():
        opt.state[p] = {"step": torch.tensor(7.0),
                        "exp_avg": torch.ones_like(p),
                        "exp_avg_sq": torch.ones_like(p)}
    scene2, opt2, stats2 = grow_capacity(scene, opt, _hot_stats(n), 128)
    assert scene2.capacity == 128
    assert int(scene2.num_valid) == n
    assert tuple(stats2.denom.shape) == (128,)
    assert [g["name"] for g in opt2.param_groups] == \
        [g["name"] for g in opt.param_groups]
    assert opt2.param_groups[0]["schedule"] is opt.param_groups[0][
        "schedule"]
    for name, p in scene2.params().items():
        assert p.requires_grad and p.is_leaf
        st = opt2.state[p]
        assert float(st["step"]) == 7.0, name
        assert st["exp_avg"].shape == p.shape
        assert bool((st["exp_avg"][:n] == 1).all())
        assert not st["exp_avg"][n:].any()
        assert not st["exp_avg_sq"][n:].any()
        assert not p.detach()[n:].any()

    new_scene, _, _, info = densify_and_prune(
        scene2, opt2, stats2, torch.Generator().manual_seed(0),
        grad_threshold=1e-4, min_opacity=0.005, extent=1.0,
        percent_dense=0.01)
    assert int(info["overflow"]) == 0
    # all 32 split into 64 children, parents pruned
    assert int(new_scene.num_valid) == 2 * n
    # an Adam step on the grown optimizer runs
    for p in scene2.params().values():
        p.grad = torch.ones_like(p)
    opt2.step()
    assert float(opt2.state[scene2.xyz]["step"]) == 8.0


def _adam_groups(opt_state, names):
    """{group: {mu, nu, count}} of an optax multi_transform over Adams."""
    out = {}
    for name in names:
        adam = opt_state.inner_states[name].inner_state[0]
        out[name] = dict(mu=np.asarray(adam.mu[name]),
                         nu=np.asarray(adam.nu[name]),
                         count=int(adam.count))
    return out


def _jax_draws(key, n):
    """The split noise goi_tpu's densify_and_prune draws from `key`."""
    draws = []
    for _ in range(2):
        key, sub = jax.random.split(key)
        draws.append(np.asarray(jax.random.normal(sub, (n, 3))))
    return np.stack(draws)


def _trained_jax_state(capacity, seed):
    """goi_tpu's RGB state after two steps: non-zero moments and stats."""
    js = make_random_scene(n=200, seed=seed, capacity=capacity)
    jc = make_test_camera(width=48, height=48)
    target = make_random_scene(n=150, seed=seed + 1)
    jcfg = JConfig(max_instances=1 << 13, backend="pallas")
    from goi_tpu.raster import render as jrender
    gt = jrender(target, jc, jnp.zeros(3), jcfg)["render"]
    init_fn, step_fn, _ = j_trainer(JOptim(), jcfg)
    state = init_fn(js)
    step = jax.jit(step_fn)
    for _ in range(2):
        state, _ = step(state, jc, gt, jnp.zeros(3))
    return state


@pytest.mark.parametrize("case", ["room", "overflow"])
def test_densify_matches_goi_tpu(case, monkeypatch):
    """One state (scene, Adam moments, stats) through both packages'
    densify_and_prune, the port fed the JAX split draws: the densified
    scene, `valid`, the moments and info. 'room' has free rows for every
    clone and child and prunes by screen size and world scale too;
    'overflow' runs out of free rows, so some splits keep their
    parents."""
    capacity = 400 if case == "room" else 215
    jstate = _trained_jax_state(capacity, seed=31)
    js = jstate.scene
    grads = np.asarray(jstate.stats.xyz_grad_accum) / np.maximum(
        np.asarray(jstate.stats.denom), 1.0)
    kw = dict(grad_threshold=float(np.quantile(grads[:200], 0.7)),
              min_opacity=0.05, extent=4.0, percent_dense=0.01,
              max_screen_size=6 if case == "room" else 0)
    key = jax.random.PRNGKey(5)
    j_scene, j_opt, _, j_info = jdensify.densify_and_prune(
        js, jstate.opt_state, jstate.stats, key, **kw)

    names = js.PARAM_FIELDS
    scene = to_torch_scene(js)
    scene = scene.with_params(_leaves(scene))
    opt = make_full_training_optimizer(OptimConfig(), 1.0, scene.params())
    interop.adam_state_from_numpy(opt, _adam_groups(jstate.opt_state,
                                                    names))
    stats = DensifyStats(**{k: torch.tensor(np.asarray(
        getattr(jstate.stats, k))) for k in ("xyz_grad_accum", "denom",
                                             "max_radii")})
    draws = torch.as_tensor(_jax_draws(key, capacity))
    monkeypatch.setattr(densify, "_split_noise",
                        lambda gen, n, device: draws.to(device))
    t_scene, t_opt, _, t_info = densify_and_prune(
        scene, opt, stats, torch.Generator().manual_seed(0), **kw)

    for k in INFO_KEYS:
        assert int(t_info[k]) == int(j_info[k]), k
    assert int(t_info["n_clone"]) > 0 and int(t_info["n_split"]) > 0
    if case == "room":
        assert int(t_info["overflow"]) == 0
    else:
        assert int(t_info["overflow"]) > 0
    np.testing.assert_array_equal(t_scene.valid.numpy(),
                                  np.asarray(j_scene.valid))
    for k in names:
        np.testing.assert_allclose(t_scene.params()[k].detach().numpy(),
                                   np.asarray(getattr(j_scene, k)),
                                   err_msg=k, **FLOAT_TOL)
    want = _adam_groups(j_opt, names)
    for k, p in t_scene.params().items():
        st = t_opt.state[p]
        np.testing.assert_array_equal(st["exp_avg"].numpy(), want[k]["mu"])
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(),
                                      want[k]["nu"])
        assert float(st["step"]) == want[k]["count"] == 2


def test_reset_opacity_matches_goi_tpu():
    jstate = _trained_jax_state(260, seed=41)
    j_scene, j_opt = jdensify.reset_opacity(jstate.scene, jstate.opt_state)
    names = jstate.scene.PARAM_FIELDS
    scene = to_torch_scene(jstate.scene)
    scene = scene.with_params(_leaves(scene))
    opt = make_full_training_optimizer(OptimConfig(), 1.0, scene.params())
    interop.adam_state_from_numpy(opt, _adam_groups(jstate.opt_state,
                                                    names))
    t_scene, t_opt = reset_opacity(scene, opt)
    assert t_scene.opacity is scene.opacity
    np.testing.assert_allclose(t_scene.opacity.detach().numpy(),
                               np.asarray(j_scene.opacity), **FLOAT_TOL)
    assert float(t_scene.get_opacity().detach().max()) <= 0.01 + 1e-7
    want = _adam_groups(j_opt, names)
    for k, p in t_scene.params().items():
        np.testing.assert_array_equal(t_opt.state[p]["exp_avg"].numpy(),
                                      want[k]["mu"], err_msg=k)
        np.testing.assert_array_equal(t_opt.state[p]["exp_avg_sq"].numpy(),
                                      want[k]["nu"], err_msg=k)
    assert not t_opt.state[t_scene.opacity]["exp_avg"].any()
    assert t_opt.state[t_scene.xyz]["exp_avg"].any()
    assert float(t_opt.state[t_scene.opacity]["step"]) == 2.0
