"""goi_tpu_torch's one binning layout, the chunked stream, against
goi_tpu's legacy aligned layout (`bin_splats(align=K)`,
`RasterConfig(layout="aligned")` with its 'scatter' / 'sorted' /
'cumsum' reduces, backend='pallas' in interpret mode) on the same seeded
inputs: the same instances in each tile in the same order, so the same
frames, gradients and lifted features.

The inputs and the comparisons within goi_tpu are those of
tests/test_binning_chunked.py and tests/test_chunked_render.py; across
the packages the port is held where its own tests hold it: frames at
5e-5 (tests/test_torch_render.py), gradients by the magnitude-relative
bar of tests/test_torch_reduce.py::test_chain_matches_pallas_chain (the
pallas blend's moment-basis exponent and log-space transmittance differ
from the port's, PARITY.md deviations 3 and 8, and the rotation
gradients of isotropic Gaussians are noise), lifted features at
tests/test_torch_trace.py's 1e-4 (the port sums them by the blocked
prefix, PARITY.md deviation 3, where the aligned layout sums serially)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goi_tpu.raster import RasterConfig as JConfig
from goi_tpu.raster import binning as jbin
from goi_tpu.raster import preprocess as jpre
from goi_tpu.raster import render as jrender
from goi_tpu.raster import trace as jtrace
from goi_tpu_torch.raster import binning as tbin
from goi_tpu_torch.raster import preprocess as tpre
from goi_tpu_torch.raster.render import RasterConfig, render, trace
from tests.conftest import make_random_scene, make_test_camera
from tests.test_torch_core import to_torch_camera, to_torch_scene

torch.set_num_threads(1)

FRAME_TOL = dict(rtol=5e-5, atol=5e-5)
IMAGES = ("render", "semantics", "depth", "alpha")
CHUNKED = RasterConfig(max_instances=1 << 14)
J_ALIGNED = JConfig(max_instances=1 << 14, backend="pallas",
                    layout="aligned", reduce="scatter")


@pytest.mark.parametrize("cull", [True, False])
def test_chunked_segments_match_aligned(cull):
    """tests/test_binning_chunked.py::test_chunked_matches_aligned_segments
    across the packages (K = 128 as there): each tile's run of Gaussian
    ids in the port's chunked stream is the run of goi_tpu's aligned
    segment, and the raw instance counts agree."""
    js = make_random_scene(n=500, seed=0)
    jsp = jpre.preprocess(js, make_test_camera(width=64, height=48))
    tsp = tpre.Splats(**{f.name: torch.as_tensor(
        np.array(getattr(jsp, f.name))) for f in dataclasses.fields(jsp)})
    gx, gy, n_inst, k = 4, 3, 1 << 13, 128
    a = jbin.bin_splats(jsp, grid_x=gx, grid_y=gy, max_instances=n_inst,
                        align=k, cull=cull)
    c = tbin.bin_splats_chunked(tsp, grid_x=gx, grid_y=gy,
                                max_instances=n_inst + 2048, chunk_k=k,
                                cull=cull)
    assert int(c.num_instances) == int(a.num_instances)
    a_list = np.asarray(a.point_list)
    for t in range(gx * gy):
        np.testing.assert_array_equal(
            c.point_list[c.tile_start[t]:c.tile_end[t]].numpy(),
            a_list[int(a.tile_start[t]):int(a.tile_end[t])],
            err_msg=f"tile {t}")


def test_chunked_forward_matches_aligned():
    """tests/test_chunked_render.py::test_chunked_forward_matches_aligned
    across the packages: the port's frame against goi_tpu's aligned one,
    radii and raw instance counts equal."""
    js = make_random_scene(n=600, seed=11)
    jc = make_test_camera(width=80, height=48, angle=0.3)
    bg = np.array([0.2, 0.0, 1.0], np.float32)
    got = render(to_torch_scene(js), to_torch_camera(jc), torch.as_tensor(bg),
                 CHUNKED)
    want = jrender(js, jc, jnp.asarray(bg), J_ALIGNED)
    for k in IMAGES:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **FRAME_TOL)
    for k in ("radii", "num_instances"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), k)


def _full_loss(out, xp):
    return (xp.sum(out["render"] ** 2) + xp.sum(out["semantics"] ** 2)
            + xp.sum(out["depth"]) + xp.sum(out["alpha"]))


@pytest.mark.parametrize("reduce", ["scatter", "sorted", "cumsum"])
def test_chunked_gradients_match_aligned(reduce):
    """tests/test_chunked_render.py::test_chunked_gradients_match_aligned
    across the packages: the port's gradients against those of each of
    goi_tpu's aligned reduces, within 5e-3 of the larger of |want| and
    its 99th percentile, plus 5e-4."""
    js = make_random_scene(n=400, seed=12)
    jc = make_test_camera(width=64, height=48)
    ts, tc = to_torch_scene(js), to_torch_camera(jc)
    jcfg = dataclasses.replace(J_ALIGNED, reduce=reduce)
    want = jax.grad(lambda p: _full_loss(jrender(
        js.with_params(p), jc, jnp.zeros(3), jcfg), jnp))(js.params())
    leaves = {k: v.clone().requires_grad_(True)
              for k, v in ts.params().items()}
    _full_loss(render(ts.with_params(leaves), tc, torch.zeros(3), CHUNKED),
               torch).backward()
    for k in want:
        a, b = np.asarray(want[k]), leaves[k].grad.numpy()
        scale = np.maximum(np.abs(a), np.quantile(np.abs(a), 0.99))
        np.testing.assert_array_less(np.abs(a - b), 5e-3 * scale + 5e-4,
                                     err_msg=k)


def test_chunked_trace_matches_aligned():
    """tests/test_chunked_render.py::test_chunked_trace_matches_aligned
    across the packages: hit counts equal, lifted features at 1e-4."""
    js = make_random_scene(n=500, seed=13)
    jc = make_test_camera(width=64, height=48)
    feat = np.array(jax.random.normal(jax.random.PRNGKey(0),
                                      (js.sem_dim, 48, 64)))
    got = trace(to_torch_scene(js), to_torch_camera(jc), torch.as_tensor(feat),
                torch.zeros(3), CHUNKED)
    want = jtrace(js, jc, jnp.asarray(feat), jnp.zeros(3), J_ALIGNED)
    np.testing.assert_array_equal(got["num_gsem"].numpy(),
                                  np.asarray(want["num_gsem"]))
    np.testing.assert_allclose(got["gaussian_semantics"].numpy(),
                               np.asarray(want["gaussian_semantics"]),
                               rtol=1e-4, atol=1e-4)
