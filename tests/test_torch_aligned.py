"""The legacy aligned layout of goi_tpu_torch (`bin_splats(align=K)`,
`RasterConfig(layout="aligned")` with the 'scatter' / 'sorted' / 'cumsum'
reduces) against goi_tpu's on the same seeded inputs (goi_tpu with
backend='pallas' in interpret mode).

Each case mirrors a JAX test and keeps its tolerance for what that test
compares inside one package (two reduces, or the two layouts). The port
against goi_tpu is held where the port's own tests hold it: frames at
5e-5 (tests/test_torch_render.py), gradients by the magnitude-relative
bar of tests/test_torch_reduce.py::test_chain_matches_pallas_chain (the
pallas blend's moment-basis exponent and log-space transmittance differ
from the port's, PARITY.md deviations 3 and 8, and the rotation
gradients of isotropic Gaussians are noise), lifted features at
tests/test_torch_trace.py's 1e-4."""

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
from goi_tpu.raster.render import suggest_budgets as j_suggest_budgets
from goi_tpu_torch.raster import binning as tbin
from goi_tpu_torch.raster import preprocess as tpre
from goi_tpu_torch.raster.cuda_blend import K
from goi_tpu_torch.raster.render import (RasterConfig, _effective_reduce,
                                         render, suggest_budgets,
                                         suggest_instance_budget, trace)
from tests.conftest import make_random_scene, make_test_camera
from tests.test_torch_core import to_torch_camera, to_torch_scene

torch.set_num_threads(1)

FRAME_TOL = dict(rtol=5e-5, atol=5e-5)
IMAGES = ("render", "semantics", "depth", "alpha")


def _splats(seed, n, wh, **kw):
    js = make_random_scene(n=n, seed=seed, **kw)
    jc = make_test_camera(width=wh[0], height=wh[1])
    jsp = jpre.preprocess(js, jc)
    tsp = tpre.Splats(**{f.name: torch.as_tensor(
        np.array(getattr(jsp, f.name))) for f in dataclasses.fields(jsp)})
    return jsp, tsp, (wh[0] + 15) // 16, (wh[1] + 15) // 16


@pytest.mark.parametrize("cull", [True, False])
def test_chunked_matches_aligned_segments(cull):
    """tests/test_binning_chunked.py::test_chunked_matches_aligned_segments
    on the port (K = 128 as there), plus the port's aligned binning equal
    to goi_tpu's field for field on the same Splats, the expansion-order
    view of the sort included, and under an overflowing budget."""
    jsp, tsp, gx, gy = _splats(0, 500, (64, 48))
    n_inst, k = 1 << 13, 128
    a = tbin.bin_splats(tsp, grid_x=gx, grid_y=gy, max_instances=n_inst,
                        align=k, cull=cull)
    c = tbin.bin_splats_chunked(tsp, grid_x=gx, grid_y=gy,
                                max_instances=n_inst + 2048, chunk_k=k,
                                cull=cull)
    assert int(a.num_instances) == int(c.num_instances)
    for t in range(gx * gy):
        np.testing.assert_array_equal(
            c.point_list[c.tile_start[t]:c.tile_end[t]].numpy(),
            a.point_list[a.tile_start[t]:a.tile_end[t]].numpy(),
            err_msg=f"tile {t}")
    assert bool((a.tile_start % k == 0).all())
    assert a.aligned and not c.aligned
    for budget in (n_inst, 1 << 10):
        jb = jbin.bin_splats(jsp, grid_x=gx, grid_y=gy,
                             max_instances=budget, align=k, cull=cull,
                             export_perm=True)
        tb = tbin.bin_splats(tsp, grid_x=gx, grid_y=gy,
                             max_instances=budget, align=k, cull=cull,
                             export_perm=True)
        for f in ("point_list", "tile_start", "tile_end", "num_instances",
                  "num_slots", "stream_pos", "stream_gid"):
            np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                          np.asarray(getattr(jb, f)), f)
    assert int(tb.num_slots) > 1 << 10


def test_tile_counts_and_budgets_match_goi_tpu():
    """tile_counts, exact_tile_counts and suggest_budgets(align=K) of the
    aligned layout give goi_tpu's counts and budget pair."""
    jsp, tsp, gx, gy = _splats(1, 300, (96, 64), anisotropic=True)
    np.testing.assert_array_equal(
        tbin.tile_counts(tsp, grid_x=gx, grid_y=gy).numpy(),
        np.asarray(jbin.tile_counts(jsp, grid_x=gx, grid_y=gy)))
    np.testing.assert_array_equal(
        tbin.exact_tile_counts(tsp, grid_x=gx, grid_y=gy,
                               max_instances=1 << 13).numpy(),
        np.asarray(jbin.exact_tile_counts(jsp, grid_x=gx, grid_y=gy,
                                          max_instances=1 << 13)))
    js = make_random_scene(n=300, seed=1)
    cams = [make_test_camera(angle=a) for a in (0.0, 0.6)]
    ts, tcams = to_torch_scene(js), [to_torch_camera(c) for c in cams]
    for kw in (dict(align=K), dict(layout="aligned"),
               dict(align=K, layout="aligned")):
        pair = suggest_budgets(ts, tcams, margin=1.2, minimum=256, **kw)
        assert pair == j_suggest_budgets(js, cams, margin=1.2, minimum=256,
                                         **kw), kw
    assert suggest_instance_budget(ts, tcams, margin=1.2, minimum=256,
                                   **kw) == max(pair)
    for mi, mb in ((1 << 14, None), (1 << 20, None), (1 << 22, 1 << 19),
                   (1 << 22, 1 << 20)):
        cfg = RasterConfig(max_instances=mi, max_binned=mb, layout="aligned")
        want = "cumsum" if (mb or mi) >= 1 << 19 and mi < 5 * (mb or mi) \
            else "scatter"
        assert _effective_reduce(cfg) == want
    with pytest.raises(ValueError):
        render(ts, tcams[0], torch.zeros(3),
               RasterConfig(layout="aligned", reduce="chain"))
    with pytest.raises(ValueError):
        render(ts, tcams[0], torch.zeros(3),
               RasterConfig(layout="aligned", dense_reduce=True))


def _close_to_pallas(got, want, name):
    """The port's gradient against goi_tpu's pallas one: within 5e-3 of
    the larger of |want| and its 99th percentile, plus 5e-4."""
    a, b = np.asarray(want), np.asarray(got)
    scale = np.maximum(np.abs(a), np.quantile(np.abs(a), 0.99))
    np.testing.assert_array_less(np.abs(a - b), 5e-3 * scale + 5e-4,
                                 err_msg=name)


def _grads(render_fn, scene, params, loss):
    """(grads of loss(render_fn(scene with params)), the outputs)."""
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    out = render_fn(scene.with_params(leaves))
    loss(out).backward()
    return {k: v.grad.numpy() for k, v in leaves.items()}, out


def _full_loss(out, xp):
    return (xp.sum(out["render"] ** 2) + xp.sum(out["semantics"] ** 2)
            + xp.sum(out["depth"]) + xp.sum(out["alpha"]))


def _overflow_loss(out, xp):
    return xp.sum(out["render"] ** 2) + xp.sum(out["alpha"])


# (JAX test, seed, scene kwargs, frame, budget, loss, reduce, the JAX
# test's tolerance between the two reduces)
REDUCE_CASES = {
    "test_sorted_reduce_matches_scatter_reduce": (
        21, {}, (64, 48), 1 << 14, _full_loss, "sorted",
        dict(rtol=2e-5, atol=2e-6)),
    "test_sorted_reduce_overflow_masks_dropped_instances": (
        22, dict(spread=0.3), (48, 32), 1 << 10, _overflow_loss, "sorted",
        dict(rtol=2e-5, atol=2e-6)),
    "test_cumsum_reduce_matches_scatter_reduce": (
        23, {}, (64, 48), 1 << 14, _full_loss, "cumsum",
        dict(rtol=5e-3, atol=5e-4)),
    "test_cumsum_reduce_overflow_masks_dropped_instances": (
        24, dict(spread=0.3), (48, 32), 1 << 10, _overflow_loss, "cumsum",
        dict(rtol=5e-3, atol=5e-4)),
}


@pytest.mark.parametrize("case", sorted(REDUCE_CASES))
def test_aligned_reduces_match_scatter_and_goi_tpu(case):
    """tests/test_pallas_blend.py's four aligned-reduce tests on the port:
    the reduce's gradients equal the aligned 'scatter' reduce's at that
    test's tolerance (the overflow cases on a truncated binning), and
    the port's 'scatter' gradients match goi_tpu's (_close_to_pallas)."""
    seed, kw, (w, h), budget, loss, reduce, tol = REDUCE_CASES[case]
    js = make_random_scene(n=400 if not kw else 300, seed=seed, **kw)
    jc = make_test_camera(width=w, height=h)
    ts, tc = to_torch_scene(js), to_torch_camera(jc)
    jcfg = JConfig(max_instances=budget, backend="pallas", layout="aligned",
                   reduce="scatter")
    want = jax.grad(lambda p: loss(jrender(js.with_params(p), jc,
                                           jnp.zeros(3), jcfg), jnp))(
        js.params())
    got = {}
    for red in ("scatter", reduce):
        cfg = RasterConfig(max_instances=budget, layout="aligned",
                           reduce=red)
        got[red], out = _grads(
            lambda s: render(s, tc, torch.zeros(3), cfg), ts, ts.params(),
            lambda o: loss(o, torch))
    if budget < 1 << 14:
        assert int(out["num_slots"]) > budget
    for k in want:
        assert np.isfinite(got[reduce][k]).all(), k
        np.testing.assert_allclose(got[reduce][k], got["scatter"][k],
                                   err_msg=k, **tol)
        _close_to_pallas(got["scatter"][k], want[k], k)


CHUNKED = RasterConfig(max_instances=1 << 14)
ALIGNED = RasterConfig(max_instances=1 << 14, layout="aligned",
                       reduce="scatter")
J_ALIGNED = JConfig(max_instances=1 << 14, backend="pallas",
                    layout="aligned", reduce="scatter")


def test_chunked_forward_matches_aligned():
    """tests/test_chunked_render.py::test_chunked_forward_matches_aligned
    (3e-6 between the layouts), and the aligned frame against goi_tpu's."""
    js = make_random_scene(n=600, seed=11)
    jc = make_test_camera(width=80, height=48, angle=0.3)
    ts, tc = to_torch_scene(js), to_torch_camera(jc)
    bg = np.array([0.2, 0.0, 1.0], np.float32)
    oc = render(ts, tc, torch.as_tensor(bg), CHUNKED)
    oa = render(ts, tc, torch.as_tensor(bg), ALIGNED)
    oj = jrender(js, jc, jnp.asarray(bg), J_ALIGNED)
    for k in IMAGES:
        np.testing.assert_allclose(oc[k].numpy(), oa[k].numpy(), rtol=3e-6,
                                   atol=3e-6, err_msg=k)
        np.testing.assert_allclose(oa[k].numpy(), np.asarray(oj[k]),
                                   err_msg=k, **FRAME_TOL)
    for k in ("num_instances", "num_slots", "radii"):
        np.testing.assert_array_equal(oa[k].numpy(), np.asarray(oj[k]), k)


def test_chunked_gradients_match_aligned():
    """tests/test_chunked_render.py::test_chunked_gradients_match_aligned
    (5e-3 / 5e-4 between the layouts) on the port, every aligned reduce,
    and the aligned gradients against goi_tpu's."""
    js = make_random_scene(n=400, seed=12)
    jc = make_test_camera(width=64, height=48)
    ts, tc = to_torch_scene(js), to_torch_camera(jc)
    want = jax.grad(lambda p: _full_loss(jrender(
        js.with_params(p), jc, jnp.zeros(3), J_ALIGNED), jnp))(js.params())
    gc, _ = _grads(lambda s: render(s, tc, torch.zeros(3), CHUNKED), ts,
                   ts.params(), lambda o: _full_loss(o, torch))
    for reduce in ("scatter", "sorted", "cumsum"):
        cfg = dataclasses.replace(ALIGNED, reduce=reduce)
        ga, _ = _grads(lambda s: render(s, tc, torch.zeros(3), cfg), ts,
                       ts.params(), lambda o: _full_loss(o, torch))
        for k in want:
            np.testing.assert_allclose(gc[k], ga[k], rtol=5e-3, atol=5e-4,
                                       err_msg=f"{reduce} {k}")
            _close_to_pallas(ga[k], want[k], f"{reduce} {k}")


def test_chunked_trace_matches_aligned():
    """tests/test_chunked_render.py::test_chunked_trace_matches_aligned on
    the port: hit counts equal, render 3e-6; the lifted features at
    tests/test_torch_trace.py's 1e-4, not the JAX test's 2e-5 / 2e-6,
    because the port's chunked trace sums them by the blocked prefix
    (PARITY.md deviation 3) where the aligned one, as both of goi_tpu's
    layouts, sums serially. The aligned trace against goi_tpu's: hit
    counts equal, lifted features 2e-5 / 2e-6 (the same serial sums)."""
    js = make_random_scene(n=500, seed=13)
    jc = make_test_camera(width=64, height=48)
    ts, tc = to_torch_scene(js), to_torch_camera(jc)
    feat = np.array(jax.random.normal(jax.random.PRNGKey(0),
                                      (js.sem_dim, 48, 64)))
    tfeat = torch.as_tensor(feat)
    tchunk = trace(ts, tc, tfeat, torch.zeros(3), CHUNKED)
    talign = trace(ts, tc, tfeat, torch.zeros(3), ALIGNED)
    jalign = jtrace(js, jc, jnp.asarray(feat), jnp.zeros(3), J_ALIGNED)
    np.testing.assert_array_equal(tchunk["num_gsem"].numpy(),
                                  talign["num_gsem"].numpy())
    np.testing.assert_allclose(tchunk["gaussian_semantics"].numpy(),
                               talign["gaussian_semantics"].numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tchunk["render"].numpy(),
                               talign["render"].numpy(), rtol=3e-6,
                               atol=3e-6)
    np.testing.assert_array_equal(talign["num_gsem"].numpy(),
                                  np.asarray(jalign["num_gsem"]))
    np.testing.assert_allclose(talign["gaussian_semantics"].numpy(),
                               np.asarray(jalign["gaussian_semantics"]),
                               rtol=2e-5, atol=2e-6)
