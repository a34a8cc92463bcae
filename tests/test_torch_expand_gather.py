"""The fused expansion gather (goi_tpu_torch.raster.gather.expand_gather)
on the CPU: its plain version against goi_tpu's `_expand_chunked` on the
same Splats (the gather with and without the Pallas monotone gather, in
interpret mode), and the search form of the slot -> Gaussian stream,
which the CUDA kernel computes, against the scatter + cummax form. All
integer streams and gathered floats are compared exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goi_tpu.raster import binning as jbin
from goi_tpu.raster import gather as jg
from goi_tpu_torch.raster import binning as tbin
from goi_tpu_torch.raster import gather as tg
from tests.test_torch_binning import _splats

torch.set_num_threads(1)


@pytest.mark.parametrize("use_mono", [False, True])
@pytest.mark.parametrize("budget", ["above", "half"])
def test_expansion_matches_jax(use_mono, budget):
    jsp, tsp, gx, gy, demand = _splats(5, 300, (64, 48))
    m = demand + 700 if budget == "above" else demand // 2
    want = jbin._expand_chunked(jsp, grid_x=gx, grid_y=gy, n_inst=m,
                                cull=True, use_mono=use_mono)
    got = tbin._expand_chunked(tsp, grid_x=gx, grid_y=gy, n_inst=m,
                               cull=True)
    for name, a, b in zip(("tile", "g_stream", "depth_bits", "raw_total",
                           "demand"), got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)
    assert int(got[4]) == demand and (demand > m) == (budget == "half")

    # the gathered rows: the port's table through both packages' gathers
    counts_true = tsp.tiles_touched.long()
    c1 = torch.clamp(counts_true, min=1)
    base = torch.cumsum(c1, 0) - c1
    table = tbin._expansion_table(tsp, base, counts_true)
    g, rows = tg.expand_gather(table, base, m)
    np.testing.assert_array_equal(g.numpy(), np.asarray(want[1]))
    jt = jnp.asarray(table.numpy())
    if use_mono:
        jrows = jg.monotone_gather(jnp.pad(jt, ((0, 0), (0, jg.SPAN + 128))),
                                   jnp.asarray(g.numpy()))
    else:
        jrows = jt[:, jnp.asarray(g.numpy())]
    np.testing.assert_array_equal(rows.numpy().view(np.int32),
                                  np.asarray(jrows).view(np.int32))


def _numpy_stream(counts, m):
    """g_stream by the definition: slot r belongs to the last Gaussian
    whose clamped base is at or below r."""
    c1 = np.maximum(counts, 1)
    cb = np.minimum(np.cumsum(c1) - c1, m - 1)
    return np.searchsorted(cb, np.arange(m), side="right") - 1


@pytest.mark.parametrize("n,zero_share,budget,extra", [
    (2000, 0.0, 1.2, 0),      # room to spare, m a multiple of 4
    (2000, 0.4, 1.2, 3),      # zero counts (sentinel slots), ragged m
    (2000, 0.4, 0.5, 1),      # overflow: bases clamp onto slot m - 1
    (2000, 0.1, 1.0, 0),      # m equal to the demand
    (7, 0.5, 0.3, 2),         # a handful of Gaussians, deep overflow
])
def test_search_stream_equals_cummax_stream(n, zero_share, budget, extra):
    rng = np.random.default_rng(n + extra)
    counts = rng.integers(1, 12, n)
    counts[rng.random(n) < zero_share] = 0
    demand = int(np.maximum(counts, 1).sum())
    m = max(int(demand * budget) // 4 * 4 + extra, 1)
    c1 = np.maximum(counts, 1)
    base = torch.as_tensor(np.cumsum(c1) - c1)
    cummax = tg.slot_owners(base, m)
    search = tg.slot_owners_search(base, m)
    assert cummax.dtype == search.dtype == torch.int32
    np.testing.assert_array_equal(search.numpy(), cummax.numpy())
    np.testing.assert_array_equal(cummax.numpy(), _numpy_stream(counts, m))
    assert int(cummax[-1]) == n - 1
    assert (m % 4 != 0) == (extra != 0)


def test_expand_gather_cpu_is_plain_and_checks_inputs():
    rng = np.random.default_rng(1)
    table = torch.as_tensor(rng.normal(0, 1, (3, 50)).astype(np.float32))
    base = torch.arange(50) * 2
    before = tg.expand_gather.launches
    g, rows = tg.expand_gather(table, base, 77)
    assert tg.expand_gather.launches == before      # CPU: plain version
    assert torch.equal(rows, table[:, g.long()])
    assert torch.equal(g[:4], torch.tensor([0, 0, 1, 1], dtype=torch.int32))
    with pytest.raises(ValueError):
        tg.expand_gather(table, base[:10], 77)
    with pytest.raises(ValueError):
        tg.expand_gather(table, base, 0)
