"""The frozen work counts against hand counts."""

from portbench.reference import raster
from portbench.work import counts
from test_portbench_reference import splats


def test_blended_pairs_at_the_alpha_threshold():
    # alpha = 0.5 exp(-r^2 / 2) >= 1/255 for r^2 <= 2 ln 127.5 = 9.70:
    # the 29 lattice points with x^2 + y^2 <= 9
    sp = splats([(8.0, 8.0, 0.5, 1.0, [1.0])])
    assert raster.blended_pairs(sp, raster.tile_lists(sp)) == (29, 1)


def test_blended_pairs_at_the_transmittance_stop():
    # four stacked Gaussians of opacity 0.95: alpha >= 1/255 for r^2 <= 10
    # (37 pixels); at the centre 0.05^4 < 1e-4 stops the fourth, at
    # r^2 = 1 (1 - 0.95 e^-0.5)^4 = 0.032 keeps all four
    sp = splats([(8.0, 8.0, 0.95, d, [1.0]) for d in (1.0, 2.0, 3.0, 4.0)])
    assert raster.blended_pairs(sp, raster.tile_lists(sp)) == (37 * 4 - 1, 4)


def test_loss_flops():
    p = 1296 * 968
    products = 2 * p * 256 * 300 * 4
    assert products == 614_400 * p
    assert round(products / 1e9, 1) == 770.8
    assert counts.distill_loss_flops(p, 10, 300, 256) == \
        products + 2 * p * 10 * 300 * 3


def test_blend_counts_and_roofline():
    fwd = counts.blend_fwd(1000, 10, 256, 13)
    assert fwd == {"flops": 1000 * (19 + 26),
                   "bytes": 4 * (10 * (6 + 13) + 256 * 13)}
    bwd = counts.blend_bwd_semantics(1000, 10, 256, 10)
    assert bwd["flops"] == 1000 * 39
    assert counts.roofline_s({"flops": 67e12, "bytes": 1.0}) == 1.0
    assert counts.roofline_s({"flops": 1.0, "bytes": 6.7e12}) == 2.0
