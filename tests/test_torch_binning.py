"""goi_tpu_torch chunked binning against goi_tpu's, on the SAME Splats
(converted from JAX's, so float differences cannot reach the integer
stages): every output must be equal."""

import dataclasses

import numpy as np
import pytest
import torch

from goi_tpu.raster import binning as jbin
from goi_tpu.raster import preprocess as jpre
from goi_tpu_torch.raster import binning as tbin
from goi_tpu_torch.raster import preprocess as tpre
from tests.conftest import make_random_scene, make_test_camera

torch.set_num_threads(1)

K = 256
FIELDS = ("point_list", "tile_start", "tile_end", "num_instances",
          "num_slots", "chunk_base", "sort_slots", "g_stream")


def _splats(seed, n, wh, **kw):
    js = make_random_scene(n=n, seed=seed, **kw)
    jc = make_test_camera(width=wh[0], height=wh[1], angle=0.3 * seed)
    jsp = jpre.preprocess(js, jc)
    tsp = tpre.Splats(**{f.name: torch.as_tensor(
        np.array(getattr(jsp, f.name))) for f in dataclasses.fields(jsp)})
    gx = (wh[0] + 15) // 16
    gy = (wh[1] + 15) // 16
    demand = int(np.maximum(np.asarray(jsp.tiles_touched), 1).sum())
    return jsp, tsp, gx, gy, demand


def _bin_both(jsp, tsp, gx, gy, budget, cull=True, export_perm=True):
    jb = jbin.bin_splats_chunked(jsp, grid_x=gx, grid_y=gy,
                                 max_instances=budget, chunk_k=K, cull=cull,
                                 use_mono=False, export_perm=export_perm)
    tb = tbin.bin_splats_chunked(tsp, grid_x=gx, grid_y=gy,
                                 max_instances=budget, chunk_k=K, cull=cull,
                                 export_perm=export_perm)
    return jb, tb


def _assert_equal(jb, tb, fields=FIELDS):
    for f in fields:
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)), f)


@pytest.mark.parametrize("seed,n,wh,kw,cull", [
    (0, 300, (64, 48), {}, True),
    (1, 300, (96, 64), dict(anisotropic=True), True),
    (1, 300, (96, 64), dict(anisotropic=True), False),
    (2, 200, (64, 48), dict(spread=0.6), False),
])
def test_binning_matches_jax(seed, n, wh, kw, cull):
    jsp, tsp, gx, gy, demand = _splats(seed, n, wh, **kw)
    jb, tb = _bin_both(jsp, tsp, gx, gy, demand + 1000, cull=cull)
    _assert_equal(jb, tb)
    assert int(tb.num_slots) == demand
    # deep enough that some tile spans more than one K-chunk window
    assert int((tb.tile_end - tb.tile_start).max()) > 0


def test_binning_overflow_matches_jax():
    """max_instances below the demand: the stream truncates, bases clamp
    onto the last slot (repeated scatter indices), num_slots reports the
    true demand."""
    jsp, tsp, gx, gy, demand = _splats(3, 300, (64, 48))
    budget = demand // 2
    jb, tb = _bin_both(jsp, tsp, gx, gy, budget)
    _assert_equal(jb, tb)
    assert int(tb.num_slots) == demand > budget
    assert tb.point_list.shape[0] == budget


def test_binning_without_perm_and_chunk_capacity():
    jsp, tsp, gx, gy, demand = _splats(4, 120, (48, 32))
    jb, tb = _bin_both(jsp, tsp, gx, gy, demand + 64, export_perm=False)
    _assert_equal(jb, tb, FIELDS[:6])
    assert tb.sort_slots is None and tb.g_stream is None
    assert tbin.chunk_capacity(5000, 12, K) == \
        jbin.chunk_capacity(5000, 12, K)


def test_decode_cell_floor_semantics_match_jax():
    """Negative local indices (slots past an overflowing budget) need
    floor // and % (JAX's), not truncation."""
    rng = np.random.default_rng(5)
    m = 400
    local = rng.integers(-20, 12, m).astype(np.int32)
    x0 = rng.integers(0, 5, m).astype(np.int32)
    y0 = rng.integers(0, 5, m).astype(np.int32)
    w = rng.integers(1, 4, m).astype(np.int32)
    cells = rng.integers(0, 9, (m, 9))
    lo = (cells[:, :6] * 16.0 ** np.arange(6)).sum(1).astype(np.float32)
    hi = (cells[:, 6:] * 16.0 ** np.arange(3)).sum(1).astype(np.float32)
    lo[::3] = -1.0                              # fallback rows
    import jax.numpy as jnp
    jt = jbin._decode_cell(jnp.asarray(lo), jnp.asarray(hi),
                           jnp.asarray(local), jnp.asarray(x0),
                           jnp.asarray(y0), jnp.asarray(w))
    tt = tbin._decode_cell(torch.as_tensor(lo), torch.as_tensor(hi),
                           torch.as_tensor(local), torch.as_tensor(x0),
                           torch.as_tensor(y0), torch.as_tensor(w))
    for a, b in zip(tt, jt):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
