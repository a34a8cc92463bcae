"""The blend kernels' per-warp sub-tile cull (csrc/walk.cuh), through its
plain twin `blend.block_cull_plain`, never drops a pixel x instance pair
that the exact fp32 step would blend.

On scenes preprocessed and binned by the port (make_random_scene at the
sizes of tests/test_torch_render.py, plus one of thin ellipses), every
pair that `pair_alpha` calls valid, and every pair before a pixel's stop
that `chunk_weights` marks active, lies in an 8x4 block whose cull keeps
the instance; and the cull keeps strictly fewer pairs than are walked.
The same holds on seeded adversarial splats: thin rotated ellipses,
splats tuned to sit on the alpha threshold at one pixel, opacity within
1e-6 of 1/255 and of 1, means on block edges and corners and far outside
the tile, and the cases the cull cannot decide (conics that are not
positive definite, NaN fields), which it keeps.
"""

import numpy as np
import pytest
import torch

from goi_tpu_torch.raster.binning import bin_splats_chunked
from goi_tpu_torch.raster.blend import (BLOCK_H, BLOCK_W, _tile_pixel_coords,
                                        block_cull_plain, chunk_weights,
                                        pair_alpha, tile_block_origins,
                                        tile_pixel_blocks)
from goi_tpu_torch.raster.cuda_blend import K, pack
from goi_tpu_torch.raster.preprocess import TILE, preprocess
from goi_tpu_torch.raster.reference import T_EPS

torch.set_num_threads(1)

# (seed, n, (width, height), anisotropic): tests/test_torch_render.py's
# scenes and one of long thin ellipses
SCENES = [(0, 300, (64, 48), False), (2, 50, (40, 40), False),
          (5, 1500, (32, 32), False), (7, 400, (64, 48), True)]

PIXEL_BLOCK = tile_pixel_blocks()


def _scene_pairs(seed, n, wh, aniso):
    """Per chunk of every tile's range, in blend order: the pixel x
    instance masks walked, valid, active and kept (the pixel's block
    keeps the instance), each (T, 256, K)."""
    # here, so that the card tests can take the adversarial splats below
    # without JAX
    from tests.conftest import make_random_scene, make_test_camera
    from tests.test_torch_core import to_torch_camera, to_torch_scene
    js = make_random_scene(n=n, seed=seed, anisotropic=aniso)
    jc = make_test_camera(width=wh[0], height=wh[1], angle=0.2 * seed)
    ts, tc = to_torch_scene(js), to_torch_camera(jc)
    gx, gy = (wh[0] + TILE - 1) // TILE, (wh[1] + TILE - 1) // TILE
    sp = preprocess(ts, tc)
    b = bin_splats_chunked(sp, grid_x=gx, grid_y=gy, max_instances=1 << 14,
                           chunk_k=K)
    feat = pack(sp.mean2d, sp.conic, sp.opacity, sp.color,
                sp.semantics, sp.depth, b.point_list)
    xs, ys = _tile_pixel_coords(gx, gy)
    bx0, by0 = tile_block_origins(gx, gy)
    st, en = b.tile_start.long(), b.tile_end.long()
    t_all = torch.ones((gx * gy, TILE * TILE))
    lane = torch.arange(K)
    out = []
    for c in range((int((en - st).max()) + K - 1) // K):
        idx = st[:, None] + c * K + lane
        m = idx < en[:, None]
        f = feat[:, torch.clamp(idx, max=feat.shape[1] - 1)].permute(1, 2, 0)
        ck = chunk_weights(f[..., 0:2], f[..., 2:5], f[..., 5], m, xs, ys,
                           t_all)
        keep = block_cull_plain(f[:, None, :, 0:2], f[:, None, :, 2:5],
                                f[:, None, :, 5], bx0[..., None],
                                by0[..., None])              # (T, 8, K)
        walked = m[:, None, :] & (ck["p_excl"] >= T_EPS)
        out.append(dict(walked=walked, valid=ck["valid"],
                        active=ck["active"], kept=keep[:, PIXEL_BLOCK, :]))
        t_all = ck["p_incl"][..., -1]
    return out


@pytest.mark.parametrize("seed,n,wh,aniso", SCENES)
def test_cull_keeps_every_valid_pair(seed, n, wh, aniso):
    chunks = _scene_pairs(seed, n, wh, aniso)
    valid = sum(int(c["valid"].sum()) for c in chunks)
    dropped = sum(int((c["valid"] & ~c["kept"]).sum()) for c in chunks)
    assert valid > 0 and dropped == 0


@pytest.mark.parametrize("seed,n,wh,aniso", SCENES)
def test_culled_pairs_are_never_active_before_the_stop(seed, n, wh, aniso):
    """The pairs the walk blends (active: valid and before the pixel's
    stop) are all kept, so the kernels' output cannot change."""
    chunks = _scene_pairs(seed, n, wh, aniso)
    active = sum(int(c["active"].sum()) for c in chunks)
    lost = sum(int((c["active"] & ~c["kept"]).sum()) for c in chunks)
    assert active > 0 and lost == 0


@pytest.mark.parametrize("seed,n,wh,aniso", SCENES)
def test_cull_keeps_fewer_pairs_than_are_walked(seed, n, wh, aniso):
    chunks = _scene_pairs(seed, n, wh, aniso)
    walked = sum(int(c["walked"].sum()) for c in chunks)
    kept = sum(int((c["walked"] & c["kept"]).sum()) for c in chunks)
    assert 0 < kept < walked


# ---- adversarial splats over a 32x32 pixel region (2x2 tiles, 32 blocks)

REGION = 32
N_ADV = 3000


def _conic(lam1, lam2, theta):
    """[a, b, c] of R diag(lam1, lam2) R^T."""
    co, si = np.cos(theta), np.sin(theta)
    return np.stack([lam1 * co ** 2 + lam2 * si ** 2,
                     (lam1 - lam2) * co * si,
                     lam1 * si ** 2 + lam2 * co ** 2], -1)


def _thin(rng, n, lo=1e-3, hi=1.0):
    """Rotated ellipses with eigenvalue ratios up to 1e4."""
    lam1 = np.exp(rng.uniform(np.log(lo), np.log(hi), n))
    return _conic(lam1, lam1 * 10.0 ** rng.uniform(0, 4, n),
                  rng.uniform(0, np.pi, n))


def _on_threshold(rng, mean, conic):
    """Opacity that puts alpha within 1e-6 (relative) of 1/255 at one
    random pixel of the region (clipped to [1/255, 1])."""
    px = rng.integers(0, REGION, (len(mean), 2)).astype(np.float64)
    d = mean - px
    q = conic[:, 0] * d[:, 0] ** 2 + 2 * conic[:, 1] * d[:, 0] * d[:, 1] \
        + conic[:, 2] * d[:, 1] ** 2
    opa = np.exp(np.minimum(0.5 * q, 50.0)) / 255.0 \
        * (1 + rng.uniform(-1e-6, 1e-6, len(q)))
    return np.clip(opa, 1 / 255, 1.0)


def _adversarial(case, rng):
    n = N_ADV
    mean = rng.uniform(-4, REGION + 4, (n, 2))
    conic = _thin(rng, n)
    opa = rng.uniform(0.005, 1.0, n)
    if case == "thin_rotated":
        pass
    elif case == "on_threshold":
        opa = _on_threshold(rng, mean, conic)
    elif case == "opacity_near_min":
        conic = _thin(rng, n, 1e-2, 10.0)
        mean = rng.integers(0, REGION, (n, 2)) + rng.choice(
            [0.0, 0.5, 1e-3, -1e-3], (n, 2))
        opa = 1 / 255 + rng.uniform(-1e-6, 1e-6, n)
    elif case == "opacity_near_one":
        opa = 1.0 - rng.uniform(0, 1e-6, n)
    elif case == "edges_and_corners":
        # means on block edges and corners: x on multiples of 8 (and the
        # last pixel of a block), y on multiples of 4, and half a pixel off
        mean = np.stack([
            rng.integers(-1, 5, n) * BLOCK_W + rng.choice([0, -1, 7, 7.5, -0.5],
                                                          n),
            rng.integers(-1, 9, n) * BLOCK_H + rng.choice([0, -1, 3, 3.5, -0.5],
                                                          n)], -1)
        opa = _on_threshold(rng, mean, conic)
    elif case == "far_outside":
        ang = rng.uniform(0, 2 * np.pi, n)
        dist = np.exp(rng.uniform(np.log(20), np.log(2000), n))
        mean = REGION / 2 + dist[:, None] * np.stack([np.cos(ang),
                                                      np.sin(ang)], -1)
        conic = _thin(rng, n, 1e-7, 1e-3)
        opa = _on_threshold(rng, mean, conic)
    elif case == "not_positive_definite":
        # a <= 0, then b^2 > a c with a, c > 0, then c <= 0
        conic = np.abs(rng.normal(0, 1, (n, 3)))
        third = np.arange(n) * 3 // n
        conic[third == 0, 0] *= -rng.choice([0.0, 1.0], (third == 0).sum())
        mid = third == 1
        conic[mid, 1] = np.sqrt(conic[mid, 0] * conic[mid, 2]) \
            * rng.choice([-1.0, 1.0], mid.sum()) \
            * rng.uniform(1.001, 1.5, mid.sum())
        conic[third == 2, 2] *= -rng.choice([0.0, 1.0], (third == 2).sum())
    elif case == "nan_fields":
        fields = np.concatenate([mean, conic, opa[:, None]], -1)
        fields[np.arange(n), rng.integers(0, 6, n)] = np.nan
        mean, conic, opa = fields[:, :2], fields[:, 2:5], fields[:, 5]
    else:
        raise ValueError(case)
    return tuple(torch.as_tensor(np.asarray(a, np.float32))
                 for a in (mean, conic, opa))


ADVERSARIAL = ["thin_rotated", "on_threshold", "opacity_near_min",
               "opacity_near_one", "edges_and_corners", "far_outside",
               "not_positive_definite", "nan_fields"]
UNDECIDABLE = ("not_positive_definite", "nan_fields")


@pytest.mark.parametrize("case", ADVERSARIAL)
def test_cull_never_drops_a_blending_pair_on_adversarial_splats(case):
    rng = np.random.default_rng(ADVERSARIAL.index(case))
    mean, conic, opa = _adversarial(case, rng)
    g = REGION // TILE
    bx0, by0 = tile_block_origins(g, g)              # (4, 8) each
    keep = block_cull_plain(mean[:, None], conic[:, None], opa[:, None],
                            bx0.reshape(-1), by0.reshape(-1))  # (n, 32)
    xs, ys = _tile_pixel_coords(g, g)                 # (4, 256) each
    _, _, _, _, valid = pair_alpha(
        mean.expand(g * g, -1, -1), conic.expand(g * g, -1, -1),
        opa.expand(g * g, -1), torch.ones((g * g, len(opa)), dtype=bool),
        xs, ys)                                       # (4, 256, n)
    block = torch.arange(g * g)[:, None] * 8 + PIXEL_BLOCK   # (4, 256)
    kept = keep.T[block]                              # (4, 256, n)
    assert not bool((valid & ~kept).any())
    if case in UNDECIDABLE:
        assert bool(keep.all())
    else:
        # not vacuous: pairs blend, and whole blocks are dropped
        assert bool(valid.any()) and not bool(keep.all())
