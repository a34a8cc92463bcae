"""goi_tpu_torch trace() (the trace kernel's plain version on the CPU)
against goi_tpu trace(): backend='pallas' in interpret mode and the XLA
walk, and the numpy oracle of tests/test_trace.py, on its scenes and at
its tolerances (num_gsem exactly, gaussian_semantics at rtol = atol =
1e-4), and on the chunked-trace scene of tests/test_chunked_render.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goi_tpu.raster import RasterConfig as JConfig
from goi_tpu.raster import trace as jtrace
from goi_tpu_torch.raster import RasterConfig, render, trace
from goi_tpu_torch.raster.binning import bin_splats_chunked
from goi_tpu_torch.raster.cuda_blend import K, blend_fwd_plain, pack
from goi_tpu_torch.raster.cuda_trace import trace_fwd, trace_fwd_plain
from goi_tpu_torch.raster.preprocess import preprocess
from goi_tpu_torch.raster.render import image_to_tiles
from tests.conftest import make_random_scene, make_test_camera
from tests.test_torch_core import to_torch_camera, to_torch_scene
from tests.test_trace import CFG as J_XLA_CFG
from tests.test_trace import oracle_trace

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
TCFG = RasterConfig(max_instances=1 << 14)


def _img(s, h, w, seed=0):
    return np.random.default_rng(seed).normal(0, 1, (s, h, w)) \
        .astype(np.float32)


def _port(js, jc, img, cfg=TCFG, bg=np.zeros(3, np.float32)):
    return trace(to_torch_scene(js), to_torch_camera(jc),
                 torch.as_tensor(img), torch.as_tensor(bg), cfg)


@pytest.mark.parametrize("wh,jcfg", [
    ((32, 32), J_XLA_CFG),                                   # XLA walk
    ((28, 24), JConfig(max_instances=1 << 14, backend="pallas")),
])
def test_trace_matches_jax_and_oracle(wh, jcfg):
    """tests/test_trace.py's two cases: the 32x32 frame against the XLA
    walk, the 28x24 frame (tile padding: the ones channel must count
    hits inside the image only) against the pallas kernel."""
    w, h = wh
    js = make_random_scene(n=80, seed=6)
    jc = make_test_camera(width=w, height=h)
    img = _img(10, h, w)
    out = _port(js, jc, img)
    want = jtrace(js, jc, jnp.asarray(img), jnp.zeros(3), jcfg)
    exp_sem, exp_cnt = oracle_trace(js, jc, jnp.asarray(img))

    assert out["num_gsem"].dtype == torch.int32
    np.testing.assert_array_equal(out["num_gsem"].numpy(), exp_cnt)
    np.testing.assert_array_equal(out["num_gsem"].numpy(),
                                  np.asarray(want["num_gsem"]))
    np.testing.assert_allclose(out["gaussian_semantics"].numpy(), exp_sem,
                               **TOL)
    np.testing.assert_allclose(out["gaussian_semantics"].numpy(),
                               np.asarray(want["gaussian_semantics"]), **TOL)
    assert exp_cnt.sum() > 0
    if jcfg.backend == "pallas":    # the XLA walk bins the aligned layout
        for k in ("num_slots", "max_tile_depth"):
            assert int(out[k]) == int(want[k]), k

    # the embedded render is render()'s (tests/test_trace.py's 1e-5)
    ref = render(to_torch_scene(js), to_torch_camera(jc), torch.zeros(3),
                 TCFG)
    np.testing.assert_allclose(out["render"].numpy(), ref["render"].numpy(),
                               rtol=1e-5, atol=1e-5)


def test_trace_matches_jax_chunked():
    """tests/test_chunked_render.py's chunked-trace scene (n=500 seed 13,
    64x48), through each of the port's reduces: counts exact. That test's
    2e-5 / 2e-6 bar holds two JAX layouts that sum in one order; the port
    sums each Gaussian's hits in another (up to 2.5e-5 apart on sums of
    ~15), so features are held at tests/test_trace.py's 1e-4 and the
    render at tests/test_torch_render.py's 5e-5 (the TPU kernel's
    exponent is a moment-basis expansion, PARITY.md deviation 8)."""
    js = make_random_scene(n=500, seed=13)
    jc = make_test_camera(width=64, height=48)
    img = _img(js.sem_dim, 48, 64, seed=13)
    want = jtrace(js, jc, jnp.asarray(img), jnp.zeros(3),
                  JConfig(max_instances=1 << 14, backend="pallas"))
    for cfg in (TCFG, RasterConfig(max_instances=1 << 14, reduce="chain"),
                RasterConfig(max_instances=1 << 14, reduce="chain",
                             dense_reduce=True)):
        out = _port(js, jc, img, cfg)
        np.testing.assert_array_equal(out["num_gsem"].numpy(),
                                      np.asarray(want["num_gsem"]))
        np.testing.assert_allclose(out["gaussian_semantics"].numpy(),
                                   np.asarray(want["gaussian_semantics"]),
                                   **TOL)
        np.testing.assert_allclose(out["render"].numpy(),
                                   np.asarray(want["render"]), rtol=5e-5,
                                   atol=5e-5)


def test_trace_reduces_and_backends_agree():
    """'scatter', 'chain' and the fused chain sum the same rows: counts
    exact, the fused chain bit-identical to the chain; the reference
    backend (the plain version on any device) equals the default on the
    CPU; a non-zero background reaches the render only."""
    js = make_random_scene(n=300, seed=2)
    jc = make_test_camera(width=48, height=40, angle=0.5)
    img = _img(6, 40, 48, seed=2)
    bg = np.array([0.3, 0.1, 0.8], np.float32)
    outs = {name: _port(js, jc, img, cfg, bg) for name, cfg in (
        ("scatter", RasterConfig(max_instances=1 << 14, reduce="scatter")),
        ("chain", RasterConfig(max_instances=1 << 14, reduce="chain")),
        ("dense", RasterConfig(max_instances=1 << 14, reduce="chain",
                               dense_reduce=True)),
        ("reference", RasterConfig(max_instances=1 << 14,
                                   backend="reference")))}
    base = outs["scatter"]
    assert int(base["num_gsem"].sum()) > 0
    assert base["gaussian_semantics"].shape == (300, 6)
    for name, out in outs.items():
        assert torch.equal(out["num_gsem"], base["num_gsem"]), name
        torch.testing.assert_close(out["gaussian_semantics"],
                                   base["gaussian_semantics"], rtol=1e-5,
                                   atol=1e-5)
        assert torch.equal(out["render"], base["render"]), name
    for k in ("gaussian_semantics", "num_gsem"):
        assert torch.equal(outs["dense"][k], outs["chain"][k]), k
        assert torch.equal(outs["reference"][k], base[k]), k
    ref = render(to_torch_scene(js), to_torch_camera(jc),
                 torch.as_tensor(bg), TCFG)
    torch.testing.assert_close(base["render"], ref["render"], rtol=1e-5,
                               atol=1e-5)


def test_trace_fwd_plain_raw_output_and_rows():
    """The plain version's raw output equals the forward blend's (its
    sequential transmittance is the CPU cumprod's order), and its rows
    are the per-instance hit sums: the ones channel is an integer count
    no larger than the tile's 256 pixels, zero past the kept stream."""
    js = make_random_scene(n=1500, seed=5)          # tiles deeper than K
    jc = make_test_camera(width=32, height=32, angle=1.0)
    ts, tc = to_torch_scene(js), to_torch_camera(jc)
    sp = preprocess(ts, tc)
    b = bin_splats_chunked(sp, grid_x=2, grid_y=2, max_instances=1 << 14,
                           chunk_k=K)
    assert int((b.tile_end - b.tile_start).max()) > K
    feat = pack(sp.mean2d, sp.conic, sp.opacity, sp.color,
                sp.semantics, sp.depth, b.point_list)
    img = torch.as_tensor(_img(4, 32, 32, seed=5))
    aug = image_to_tiles(torch.cat([img, torch.ones(1, 32, 32)]), 2, 2)
    raw, rows = trace_fwd_plain(feat, b.tile_start, b.tile_end, aug, 2)
    raw_t, rows_t = trace_fwd(feat, b.tile_start, b.tile_end, aug, 2)
    assert torch.equal(raw, raw_t) and torch.equal(rows, rows_t)
    want = blend_fwd_plain(feat, b.tile_start, b.tile_end, 2)
    torch.testing.assert_close(raw, want, rtol=1e-6, atol=1e-6)
    assert torch.equal(raw[..., -2:], want[..., -2:])      # the counts
    hits = rows[:, 4]
    assert torch.equal(hits, hits.round()) and int(hits.max()) <= 256
    assert int(hits.sum()) > 0
    assert not rows[int(b.tile_end[-1]):].any()


@pytest.mark.parametrize("s_img", [32, 64])
def test_trace_wide_maps_match_jax(s_img):
    """Maps of 32 and 64 channels (past one warp's 32 lanes; the card's
    kernel lifts them in groups of 32 fields) through both packages'
    reference backends: num_gsem exactly, gaussian_semantics at
    tests/test_trace.py's 1e-4."""
    js = make_random_scene(n=150, seed=21)
    jc = make_test_camera(width=40, height=32, angle=0.3)
    img = _img(s_img, 32, 40, seed=s_img)
    want = jtrace(js, jc, jnp.asarray(img), jnp.zeros(3),
                  JConfig(max_instances=1 << 14, backend="reference"))
    out = _port(js, jc, img, RasterConfig(max_instances=1 << 14,
                                          backend="reference"))
    assert out["gaussian_semantics"].shape == (150, s_img)
    np.testing.assert_array_equal(out["num_gsem"].numpy(),
                                  np.asarray(want["num_gsem"]))
    np.testing.assert_allclose(out["gaussian_semantics"].numpy(),
                               np.asarray(want["gaussian_semantics"]), **TOL)
    assert int(out["num_gsem"].sum()) > 0
    # the default backend's plain version on the CPU gives the same
    default = _port(js, jc, img)
    for k in ("num_gsem", "gaussian_semantics"):
        assert torch.equal(default[k], out[k]), k


def test_trace_checks_its_inputs():
    js = make_random_scene(n=40, seed=1)
    ts, tc = to_torch_scene(js), to_torch_camera(make_test_camera(32, 24))
    with pytest.raises(ValueError, match="img_sem"):
        trace(ts, tc, torch.zeros(3, 24, 31), torch.zeros(3), TCFG)
    # no cap on the lifted channels off the card (the kernel's is SA_MAX)
    out = trace(ts, tc, torch.ones(31, 24, 32), torch.zeros(3), TCFG)
    assert out["gaussian_semantics"].shape == (40, 31)
    out = trace(ts, tc, torch.ones(130, 24, 32), torch.zeros(3), TCFG)
    assert out["gaussian_semantics"].shape == (40, 130)
    with pytest.raises(ValueError, match="dense_reduce"):
        trace(ts, tc, torch.ones(3, 24, 32), torch.zeros(3),
              RasterConfig(max_instances=1 << 14, dense_reduce=True))
