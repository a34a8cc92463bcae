"""The port's instance -> Gaussian reductions (raster/reduce.py, the
prefix kernel's plain version on the CPU) against goi_tpu's: the block
prefix against `_prefix_blocks` in interpret mode, the blocked segment
reduce against `_blocked_segment_reduce` and a float64 oracle, its
read-out and block term (`owner_sums_plain`, the owner_sums kernel's
plain version) against a serial fp32 sum in ascending block order, and the
'chain' reduce against 'scatter' through render's backward, mirroring
tests/test_chunked_render.py (rtol 5e-3, atol 5e-4: the two sum in
different orders)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goi_tpu.raster import RasterConfig as JConfig
from goi_tpu.raster import render as jrender
from goi_tpu.raster.pallas_blend import _blocked_segment_reduce as j_bsr
from goi_tpu.raster.pallas_blend import _prefix_blocks as j_prefix_blocks
from goi_tpu_torch.raster import reduce as R
from goi_tpu_torch.raster.render import RasterConfig, render
from tests.conftest import make_random_scene, make_test_camera
from tests.test_torch_core import to_torch_camera, to_torch_scene

torch.set_num_threads(1)

CHAIN_TOL = dict(rtol=5e-3, atol=5e-4)


def _grads(js, jc, cfg, *, semantics=True, depth=True):
    ts, tc = to_torch_scene(js), to_torch_camera(jc)
    params = {k: v.clone().requires_grad_()
              for k, v in ts.params().items()}
    out = render(ts.with_params(params), tc, torch.zeros(3), cfg)
    loss = out["render"].square().sum() + out["alpha"].sum()
    if semantics:
        loss = loss + out["semantics"].square().sum()
    if depth:
        loss = loss + out["depth"].sum()
    loss.backward()
    return {k: v.grad for k, v in params.items()}


def _check_chain_vs_scatter(js, jc, cfg, **kw):
    gs = _grads(js, jc, dataclasses.replace(cfg, reduce="scatter"), **kw)
    gc = _grads(js, jc, dataclasses.replace(cfg, reduce="chain"), **kw)
    for k in gs:
        assert torch.isfinite(gc[k]).all(), k
        np.testing.assert_allclose(gc[k].numpy(), gs[k].numpy(), err_msg=k,
                                   **CHAIN_TOL)
    return gc


@pytest.mark.parametrize("seed", [15, 21, 22, 23, 24])
def test_chain_matches_scatter(seed):
    js = make_random_scene(n=400, seed=seed)
    jc = make_test_camera(width=64, height=48)
    _check_chain_vs_scatter(js, jc, RasterConfig(max_instances=1 << 14))


def test_chain_matches_pallas_chain():
    js = make_random_scene(n=400, seed=15)
    jc = make_test_camera(width=64, height=48)
    gc = _check_chain_vs_scatter(js, jc, RasterConfig(max_instances=1 << 14))
    import jax

    def loss(params):
        out = jrender(js.with_params(params), jc, jnp.zeros(3),
                      JConfig(max_instances=1 << 14, backend="pallas",
                              reduce="chain"))
        return (jnp.sum(out["render"] ** 2) + jnp.sum(out["alpha"])
                + jnp.sum(out["semantics"] ** 2) + jnp.sum(out["depth"]))

    want = jax.grad(loss)(js.params())
    for k in gc:
        # across packages the blends differ too (the TPU kernel's
        # moment-basis exponent, PARITY.md deviation 8): the
        # magnitude-relative bar of _chain_vs_scatter_grads, with the
        # chain's atol (rotation grads of isotropic Gaussians are noise)
        a, b = np.asarray(want[k]), gc[k].numpy()
        scale = np.maximum(np.abs(a), np.quantile(np.abs(a), 0.99))
        np.testing.assert_array_less(np.abs(a - b), 5e-3 * scale + 5e-4,
                                     err_msg=k)


def test_chain_overflow_masks_dropped_instances():
    """Budget overflow: the truncated stream's rows and the clamped bounds
    keep the chain's sums equal to the scatter's."""
    js = make_random_scene(n=300, seed=16, spread=0.3)
    jc = make_test_camera(width=48, height=32)
    cfg = RasterConfig(max_instances=256)
    out = render(to_torch_scene(js), to_torch_camera(jc), torch.zeros(3),
                 cfg)
    assert int(out["num_slots"]) > cfg.max_instances
    _check_chain_vs_scatter(js, jc, cfg, semantics=False, depth=False)


def test_chain_wide_semantics():
    """d = 10 + 60 columns: wider than one warp's lanes, still reduced."""
    js = make_random_scene(n=200, seed=25, sem_dim=60)
    jc = make_test_camera(width=48, height=32)
    _check_chain_vs_scatter(js, jc, RasterConfig(max_instances=1 << 14),
                            depth=False)


def test_blocked_segment_reduce_million_rows_vs_fp64():
    """test_blocked_segment_reduce_million_rows_vs_fp64's rows, bounds and
    error budget: adversarial magnitudes, empty and block-spanning
    segments, against an exact float64 segment sum."""
    m, n_gauss, d = 1_200_000, 500_000, 21
    rng = np.random.default_rng(77)
    scale = 10.0 ** rng.uniform(-3, 3, size=(m, 1)).astype(np.float32)
    rows = (rng.standard_normal((m, d), np.float32) * scale)
    sizes = rng.geometric(0.45, size=n_gauss)
    sizes[rng.integers(0, n_gauss, 200)] += rng.integers(512, 4096, 200)
    sizes[rng.integers(0, n_gauss, 1000)] = 0
    bounds = np.zeros(n_gauss + 1, np.int64)
    np.cumsum(sizes, out=bounds[1:])
    bounds = np.minimum(bounds, m).astype(np.int32)

    acc = R.blocked_segment_reduce(torch.as_tensor(rows),
                                   torch.as_tensor(bounds)).numpy()

    ref = np.add.reduceat(
        np.vstack([rows.astype(np.float64), np.zeros((1, d))]),
        bounds, axis=0)[:n_gauss]
    ref[bounds[:-1] == bounds[1:]] = 0.0
    err = np.abs(acc - ref)
    assert np.max(err) < 0.05, np.max(err)
    assert np.quantile(err, 0.999) < 5e-3, np.quantile(err, 0.999)
    big = np.abs(ref) > 1.0
    assert np.max(err[big] / np.abs(ref[big])) < 5e-3


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("blk,nb,d", [(512, 3, 21), (128, 5, 13)])
def test_prefix_blocks_plain_matches_pallas(masked, blk, nb, d):
    rng = np.random.default_rng(blk + d)
    rows = rng.normal(0, 1, (nb * blk, d)).astype(np.float32)
    okf = (rng.uniform(size=(nb * blk, 1)) > 0.2).astype(np.float32) \
        if masked else None
    inner, tot = R.prefix_blocks_plain(
        torch.as_tensor(rows), None if okf is None else torch.as_tensor(okf),
        blk)
    j_inner, j_tot = j_prefix_blocks(
        jnp.asarray(rows), None if okf is None else jnp.asarray(okf), blk)
    assert inner.shape == j_inner.shape and tot.shape == j_tot.shape
    np.testing.assert_allclose(inner.numpy(), np.asarray(j_inner),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tot.numpy(), np.asarray(j_tot), rtol=1e-5,
                               atol=1e-4)
    assert not inner[nb * blk:].any()


def test_prefix_blocks_routes_and_checks():
    rows = torch.ones(1024, 3)
    inner, tot = R.prefix_blocks(rows)             # CPU: the plain version
    assert torch.equal(inner[:512, 0], torch.arange(512.0))
    assert torch.equal(tot, torch.full((2, 3), 512.0))
    with pytest.raises(ValueError):
        R.prefix_blocks(torch.ones(1000, 3))
    with pytest.raises(ValueError):
        R.prefix_blocks(rows, torch.ones(7))


@pytest.mark.parametrize("m", [4096, 3000])
def test_blocked_segment_reduce_matches_pallas(m):
    """A whole number of 512-row blocks and a ragged m (padded to the
    128-row block)."""
    rng = np.random.default_rng(m)
    d = 21
    rows = rng.normal(0, 1, (m, d)).astype(np.float32)
    sizes = rng.geometric(0.3, size=900)
    sizes[::97] += 300
    bounds = np.minimum(np.concatenate([[0], np.cumsum(sizes)]),
                        m + 50).astype(np.int32)
    got = R.blocked_segment_reduce(torch.as_tensor(rows),
                                   torch.as_tensor(bounds))
    want = j_bsr(jnp.asarray(rows), jnp.minimum(jnp.asarray(bounds), m), d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_block_owner_sums_match_direct_sums():
    """owner_sums_plain's whole-block term (a zero read-out) against
    float64 sums of the block totals over random owner runs."""
    rng = np.random.default_rng(5)
    tot = rng.normal(0, 1, (300, 4)).astype(np.float32)
    q = np.sort(rng.integers(0, 301, 60))
    q[0] = 0
    blk = R.CUMSUM_BLOCK
    got = R.owner_sums_plain(torch.zeros(60, 4), torch.as_tensor(q * blk),
                             torch.as_tensor(tot), blk, indexed=False)
    want = np.stack([tot[a:b].astype(np.float64).sum(0)
                     for a, b in zip(q[:-1], q[1:])])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


OWNER_BLK, OWNER_NB = 32, 40
OWNER_SPANS = (0, 1, 2, 3, 11)   # whole blocks a segment spans


def _owner_bounds(case, rng):
    """Bounds whose segments span each of OWNER_SPANS blocks, twice in a
    random order; 'repeated' puts runs of equal bounds between them and
    ends on the clamp's repeats at the stream's last row, 'end' ends on
    bounds at the stream's end nb * blk."""
    spans = rng.permutation(np.repeat(OWNER_SPANS, 2))
    p = [int(rng.integers(0, OWNER_BLK))]
    for span in spans:
        if case == "repeated":
            p += [p[-1]] * int(rng.integers(1, 3))
        q = p[-1] // OWNER_BLK + span
        lo = p[-1] if span == 0 else q * OWNER_BLK
        p.append(int(rng.integers(lo, (q + 1) * OWNER_BLK)))
    m = OWNER_NB * OWNER_BLK
    assert p[-1] < m
    if case == "repeated":
        p += [m - 1, m, m, m]
    elif case == "end":
        p += [m, m]
    return np.asarray(p, np.int64)


@pytest.mark.parametrize("d", [1, 20, 117])
@pytest.mark.parametrize("case", ["spans", "repeated", "end"])
def test_owner_sums_plain_is_a_serial_sum(case, d):
    """Both read-out forms give, bit for bit, (L[hi] - L[lo]) + one fp32
    sum of the block totals from +0.0 in ascending block order (the
    kernel's order), within 1e-5 of the same terms in float64."""
    rng = np.random.default_rng(OWNER_SPANS[-1] * d + len(case))
    p = _owner_bounds(case, rng)
    inner = rng.normal(0, 1, ((OWNER_NB + 1) * OWNER_BLK, d)).astype(
        np.float32)
    inner[OWNER_NB * OWNER_BLK:] = 0.0       # the trailing zero block
    tot = rng.normal(0, 1, (OWNER_NB, d)).astype(np.float32)
    q = p // OWNER_BLK
    assert set(OWNER_SPANS) <= set(np.diff(q).tolist())
    serial = np.empty((len(p) - 1, d), np.float32)
    exact = np.empty((len(p) - 1, d))
    for g in range(len(p) - 1):
        acc = np.zeros(d, np.float32)
        for b in range(q[g], q[g + 1]):
            acc = acc + tot[b]
        serial[g] = (inner[p[g + 1]] - inner[p[g]]) + acc
        exact[g] = (inner[p[g + 1]].astype(np.float64) - inner[p[g]]
                    + tot[q[g]:q[g + 1]].astype(np.float64).sum(0))
    t_inner, t_p, t_tot = map(torch.as_tensor, (inner, p, tot))
    for got in (R.owner_sums_plain(t_inner, t_p, t_tot, OWNER_BLK, True),
                R.owner_sums_plain(t_inner[t_p], t_p, t_tot, OWNER_BLK,
                                   False)):
        assert torch.equal(got, torch.as_tensor(serial))
        np.testing.assert_allclose(got.numpy(), exact, rtol=1e-5, atol=1e-5)


def test_owner_sums_routes_and_checks():
    """On a CPU tensor the wrapper is its plain version; shapes it does
    not take raise."""
    rng = np.random.default_rng(9)
    rows = torch.as_tensor(rng.normal(0, 1, (1024, 3)).astype(np.float32))
    p = torch.tensor([0, 3, 700, 700, 1024])
    inner, tot = R.prefix_blocks(rows)
    before = R.owner_sums.launches
    got = R.owner_sums(inner, p, tot, 512, indexed=True)
    assert torch.equal(got, R.owner_sums_plain(inner, p, tot, 512, True))
    assert torch.equal(got, R.blocked_segment_reduce(rows, p))
    assert R.owner_sums.launches == before
    with pytest.raises(ValueError):
        R.owner_sums(inner, p, tot[:, :2], 512, indexed=True)
    with pytest.raises(ValueError):
        R.owner_sums(inner, p[:, None], tot, 512, indexed=True)


def test_reduce_scatter_and_chain_sum_by_gaussian():
    rng = np.random.default_rng(3)
    gid = np.sort(rng.integers(0, 50, 700)).astype(np.int32)
    perm = rng.permutation(700)
    rows = rng.normal(0, 1, (700, 5)).astype(np.float32)
    want = np.zeros((50, 5))
    np.add.at(want, gid, rows.astype(np.float64))
    # rows in a shuffled (sorted-position) order, keyed by their ids
    got = R.reduce_scatter(torch.as_tensor(rows[perm]),
                           torch.as_tensor(gid[perm]), 50)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the chain: sort_slots[p] is the expansion slot of position p
    bounds = np.searchsorted(gid, np.arange(51)).astype(np.int64)
    got = R.reduce_chain(torch.as_tensor(rows[perm]),
                         torch.as_tensor(perm.astype(np.int32)),
                         torch.as_tensor(bounds))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
