"""RasterConfig.dense_reduce: the fused prefix + boundary read-out
(raster/reduce.py `dense_boundary_reduce`, the prefix_boundary kernel's
plain version on the CPU) gives `blocked_segment_reduce`'s bits, through
render's backward and trace's lift, with repeated bounds under a budget
overflow; against goi_tpu's `_dense_boundary_reduce` in interpret mode
and the float64 oracle of tests/test_chunked_render.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goi_tpu.raster.pallas_blend import _dense_boundary_reduce as j_dense
from goi_tpu_torch.raster import RasterConfig, render, trace
from goi_tpu_torch.raster import reduce as R
from tests.conftest import make_random_scene, make_test_camera
from tests.test_torch_core import to_torch_camera, to_torch_scene
from tests.test_torch_reduce import _grads

torch.set_num_threads(1)


def _bounds(rng, m, n, overflow=0):
    """(n + 1,) non-decreasing bounds of dense segments (sizes >= 1),
    some spanning blocks, the last `overflow` of them clamped to m - 1
    and the end to m, as cuda_blend._chain_bounds clamps under a budget
    overflow."""
    sizes = rng.geometric(0.35, size=n)
    sizes[rng.integers(0, n, 8)] += rng.integers(300, 1500, 8)
    ends = np.cumsum(sizes)
    b = np.concatenate([[0], ends]).astype(np.int64)
    if overflow:
        b[-overflow - 1:-1] = np.minimum(b[-overflow - 1:-1], m - 1)
        b[-1] = m
    return np.minimum(b, m)


@pytest.mark.parametrize("m,d,overflow", [
    (4096, 21, 0),       # whole 512-row blocks, the stream ends at m
    (3000, 13, 0),       # ragged: padded to 128-row blocks
    (2560, 11, 40),      # overflow: bounds repeat at m - 1 and at m
])
def test_dense_reduce_bit_identical_to_blocked(m, d, overflow):
    rng = np.random.default_rng(m + d)
    rows = torch.as_tensor(rng.normal(0, 1, (m, d)).astype(np.float32))
    n = 700 if overflow else 500
    bounds = torch.as_tensor(_bounds(rng, m, n, overflow))
    if overflow:
        assert int((bounds[:-1] == m - 1).sum()) > 1
    want = R.blocked_segment_reduce(rows, bounds)
    got = R.dense_boundary_reduce(rows, bounds)
    assert got.shape == (n, d)
    assert torch.equal(got, want)
    lb, tot = R.prefix_boundary_plain(
        torch.nn.functional.pad(rows, (0, 0, 0, -m % 128)),
        torch.clamp(bounds, max=m), 128)
    assert lb.shape == (n + 1, d) and tot.shape[1] == d


def test_dense_reduce_matches_pallas_dense_boundary_reduce():
    """goi_tpu's fused kernel in interpret mode (its masked branch: the
    unmasked one has the wrong arity, ROADMAP Queue 3), with the mask
    applied to the port's rows beforehand (the port's rows need none)."""
    m, n, d = 4096, 600, 21
    rng = np.random.default_rng(41)
    rows = rng.normal(0, 1, (m, d)).astype(np.float32)
    ok = (rng.uniform(size=m) > 0.1).astype(np.float32)
    p = _bounds(rng, m, n).astype(np.int32)
    ind = np.zeros(m, np.float32)
    ind[p[p < m]] = 1.0
    want = j_dense(jnp.asarray(rows), jnp.asarray(p),
                   jnp.asarray(ind)[:, None], d,
                   okf=jnp.asarray(ok)[:, None])
    got = R.dense_boundary_reduce(torch.as_tensor(rows * ok[:, None]),
                                  torch.as_tensor(p))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_dense_reduce_vs_fp64():
    """test_dense_boundary_reduce_million_rows_vs_fp64's construction and
    error budget at a quarter of its rows: adversarial magnitudes, dense
    and block-spanning segments, a row mask (applied to the rows) and a
    clamped overflow tail."""
    m, n_gauss, d = 262_144, 125_000, 64
    rng = np.random.default_rng(99)
    scale = 10.0 ** rng.uniform(-3, 3, size=(m, 1)).astype(np.float32)
    rows = rng.standard_normal((m, d), np.float32) * scale
    ok = rng.uniform(size=m) > 0.05
    sizes = rng.geometric(0.45, size=n_gauss).astype(np.int64)
    sizes[rng.integers(0, n_gauss, 25)] += rng.integers(512, 4096, 25)
    bounds = np.zeros(n_gauss + 1, np.int64)
    np.cumsum(sizes, out=bounds[1:])
    p = np.minimum(bounds, m)
    assert p[-1] == m and (p[:-1] == p[1:]).any()   # the clamped tail
    rows = rows * ok[:, None]
    acc = R.dense_boundary_reduce(torch.as_tensor(rows),
                                  torch.as_tensor(p)).numpy()
    ref = np.add.reduceat(
        np.vstack([rows.astype(np.float64), np.zeros((1, d))]), p,
        axis=0)[:n_gauss]
    ref[p[:-1] == p[1:]] = 0.0
    err = np.abs(acc - ref)
    assert np.max(err) < 0.05, np.max(err)
    assert np.quantile(err, 0.999) < 5e-3, np.quantile(err, 0.999)
    big = np.abs(ref) > 1.0
    assert np.max(err[big] / np.abs(ref[big])) < 5e-3


def test_dense_reduce_sums_counts_exactly():
    """Hit counts travel through the reduce as float32: integer rows of up
    to 256 (a tile's pixels) over 512-row blocks sum exactly."""
    rng = np.random.default_rng(8)
    m, n = 8192, 900
    counts = rng.integers(0, 257, (m, 1))
    bounds = _bounds(rng, m, n)
    want = np.add.reduceat(np.vstack([counts, [[0]]]), bounds,
                           axis=0)[:n]
    want[bounds[:-1] == bounds[1:]] = 0
    rows = torch.as_tensor(counts.astype(np.float32))
    for fn in (R.blocked_segment_reduce, R.dense_boundary_reduce):
        got = fn(rows, torch.as_tensor(bounds))
        assert np.array_equal(got.numpy().astype(np.int64), want)


@pytest.mark.parametrize("scene,cam,budget", [
    (dict(n=400, seed=15), dict(width=64, height=48), 1 << 14),
    # a real overflow: the chain's bounds repeat at m - 1 and m
    (dict(n=300, seed=16, spread=0.3), dict(width=48, height=32), 256),
])
def test_dense_reduce_render_grads_bit_identical(scene, cam, budget):
    js, jc = make_random_scene(**scene), make_test_camera(**cam)
    cfg = RasterConfig(max_instances=budget, reduce="chain")
    out = render(to_torch_scene(js), to_torch_camera(jc), torch.zeros(3),
                 cfg)
    assert (int(out["num_slots"]) > budget) == (budget == 256)
    off = _grads(js, jc, cfg)
    on = _grads(js, jc, dataclasses.replace(cfg, dense_reduce=True))
    for k in off:
        assert torch.equal(on[k], off[k]), k
    assert any(bool(g.abs().sum() > 0) for g in on.values())


def test_dense_reduce_trace_bit_identical_under_overflow():
    js = make_random_scene(n=300, seed=16, spread=0.3)
    ts, tc = to_torch_scene(js), to_torch_camera(make_test_camera(48, 32))
    img = torch.as_tensor(np.random.default_rng(1).normal(
        0, 1, (10, 32, 48)).astype(np.float32))
    cfg = RasterConfig(max_instances=256, reduce="chain")
    off = trace(ts, tc, img, torch.zeros(3), cfg)
    on = trace(ts, tc, img, torch.zeros(3),
               dataclasses.replace(cfg, dense_reduce=True))
    assert int(off["num_slots"]) > 256
    for k in ("gaussian_semantics", "num_gsem", "render"):
        assert torch.equal(on[k], off[k]), k
    assert int(on["num_gsem"].sum()) > 0


def test_dense_reduce_config_checks():
    """dense_reduce is valid with the 'chain' reduce only ('scatter', or
    'auto' resolving to it below 2^19 slots, raise)."""
    js = make_random_scene(n=40, seed=1)
    ts, tc = to_torch_scene(js), to_torch_camera(make_test_camera(32, 24))
    assert not RasterConfig().dense_reduce
    for cfg in (RasterConfig(reduce="scatter", dense_reduce=True),
                RasterConfig(max_instances=1 << 14, dense_reduce=True)):
        with pytest.raises(ValueError, match="dense_reduce"):
            render(ts, tc, torch.zeros(3), cfg)
        with pytest.raises(ValueError, match="dense_reduce"):
            trace(ts, tc, torch.ones(2, 24, 32), torch.zeros(3), cfg)
    out = render(ts, tc, torch.zeros(3),
                 RasterConfig(max_instances=1 << 19, dense_reduce=True))
    assert out["render"].shape == (3, 24, 32)
    with pytest.raises(ValueError, match="rows"):
        R.prefix_boundary(torch.zeros(1000, 3), torch.zeros(2,
                                                             dtype=torch.long))

