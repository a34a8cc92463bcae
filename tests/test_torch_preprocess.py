"""goi_tpu_torch preprocess against goi_tpu.raster.preprocess."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goi_tpu.raster import preprocess as jpre
from goi_tpu_torch.raster import preprocess as tpre
from tests.conftest import make_random_scene, make_test_camera
from tests.test_torch_core import to_torch_camera, to_torch_scene

torch.set_num_threads(1)

FLOATS = ("mean2d", "depth", "conic", "opacity", "color", "semantics")
EXACT = ("radius", "rect_min", "rect_max", "tiles_touched", "valid",
         "cell_sel")


def _compare(jsp, tsp):
    for f in FLOATS:
        np.testing.assert_allclose(getattr(tsp, f).numpy(),
                                   np.asarray(getattr(jsp, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    for f in EXACT:
        np.testing.assert_array_equal(getattr(tsp, f).numpy(),
                                      np.asarray(getattr(jsp, f)), f)


@pytest.mark.parametrize("seed,n,wh,kw", [
    (0, 300, (64, 48), {}),
    (1, 250, (96, 64), dict(anisotropic=True, capacity=300)),
    (2, 200, (40, 40), dict(sh_degree=3, spread=2.5)),
    (3, 300, (64, 48), dict(sh_degree=1, sem_dim=3)),
])
def test_preprocess_matches_jax(seed, n, wh, kw):
    js = make_random_scene(n=n, seed=seed, **kw)
    jc = make_test_camera(width=wh[0], height=wh[1], angle=0.25 * seed)
    jsp = jpre.preprocess(js, jc)
    tsp = tpre.preprocess(to_torch_scene(js), to_torch_camera(jc))
    _compare(jsp, tsp)
    # the near cull and the exact-count tables are both exercised
    assert 0 < int(tsp.valid.sum()) < n
    assert (tsp.cell_sel[:, 0] >= 0).any()


def test_preprocess_options_match_jax():
    js = make_random_scene(n=150, seed=7)
    jc = make_test_camera(width=48, height=40, angle=0.1)
    rng = np.random.default_rng(7)
    color = rng.uniform(0, 1, (150, 3)).astype(np.float32)
    masks = (rng.uniform(0, 1, 150) > 0.5).astype(np.float32)
    cov = rng.uniform(0.001, 0.01, (150, 6)).astype(np.float32)
    cov[:, 1] = cov[:, 2] = cov[:, 4] = 0.0
    jsp = jpre.preprocess(js, jc, scaling_modifier=0.7,
                          override_color=jnp.asarray(color),
                          semantic_masks=jnp.asarray(masks))
    tsp = tpre.preprocess(to_torch_scene(js), to_torch_camera(jc),
                          scaling_modifier=0.7,
                          override_color=torch.as_tensor(color),
                          semantic_masks=torch.as_tensor(masks))
    _compare(jsp, tsp)
    jsp = jpre.preprocess(js, jc, cov3d_precomp=jnp.asarray(cov))
    tsp = tpre.preprocess(to_torch_scene(js), to_torch_camera(jc),
                          cov3d_precomp=torch.as_tensor(cov))
    _compare(jsp, tsp)


def test_cell_min_q_matches_jax():
    rng = np.random.default_rng(11)
    lx = rng.uniform(-40, 40, 500).astype(np.float32)
    ly = rng.uniform(-40, 40, 500).astype(np.float32)
    ca = rng.uniform(0.001, 0.5, 500).astype(np.float32)
    cc = rng.uniform(0.001, 0.5, 500).astype(np.float32)
    cb = (rng.uniform(-0.9, 0.9, 500) * np.sqrt(ca * cc)).astype(np.float32)
    args = (lx, lx + 15, ly, ly + 15, ca, cb, cc)
    got = tpre.cell_min_q(*map(torch.as_tensor, args)).numpy()
    want = np.asarray(jpre.cell_min_q(*map(jnp.asarray, args)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (got == 0).any() and (got > 0).any()
