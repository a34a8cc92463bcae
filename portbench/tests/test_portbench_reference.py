"""The frozen plain math against hand-computed values at a tiny size:
the blend (thresholds, the transmittance stop), its semantic gradient,
the 4-term loss and Adam."""

import math

import numpy as np
import torch

from portbench.reference import raster, semantic


def splats(gs, size=(16, 16)):
    """A hand-built splat set: each g = (x, y, opacity, depth, sems),
    unit isotropic conic, one 16x16 tile."""
    n = len(gs)
    t = torch.tensor
    return {
        "mean2d": t([[g[0], g[1]] for g in gs], dtype=torch.float32),
        "conic": t([[1.0, 0.0, 1.0]] * n),
        "opacity": t([g[2] for g in gs]),
        "depth": t([g[3] for g in gs]),
        "semantics": t([g[4] for g in gs]),
        "color": torch.zeros((n, 3)),
        "rmin": torch.zeros((n, 2), dtype=torch.int64),
        "rmax": torch.ones((n, 2), dtype=torch.int64),
        "valid": torch.ones(n, dtype=torch.bool),
        "grid": (1, 1), "size": size,
    }


def sequential(sp):
    """Per pixel, in depth order, the published loop: (semantics map,
    composited pairs, pixels stopped by the transmittance)."""
    w, h = sp["size"]
    order = sorted(range(len(sp["depth"])), key=lambda i: (
        float(sp["depth"][i]), i))
    out = np.zeros((sp["semantics"].shape[1], h, w))
    pairs = stops = 0
    for y in range(h):
        for x in range(w):
            T = 1.0
            for i in order:
                mx, my = sp["mean2d"][i].tolist()
                a, b, c = sp["conic"][i].tolist()
                dx, dy = mx - x, my - y
                power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
                if power > 0:
                    continue
                alpha = min(0.99, float(sp["opacity"][i]) * math.exp(power))
                if alpha < 1 / 255:
                    continue
                if T * (1 - alpha) < 1e-4:
                    stops += 1
                    break
                out[:, y, x] += alpha * T * sp["semantics"][i].numpy()
                pairs += 1
                T *= 1 - alpha
    return out, pairs, stops


def test_two_gaussians_at_a_pixel():
    sp = splats([(3.0, 4.0, 0.5, 1.0, [1.0, 0.0]),
                 (3.0, 4.0, 0.6, 2.0, [0.0, 1.0])])
    sem = raster.render(sp, raster.tile_lists(sp), color=False)["semantics"]
    assert torch.allclose(sem[:, 4, 3], torch.tensor([0.5, 0.3]))
    a0 = 0.5 * math.exp(-0.5)
    a1 = 0.6 * math.exp(-0.5)
    assert torch.allclose(sem[:, 4, 4], torch.tensor([a0, a1 * (1 - a0)]))
    # three pixels away alpha is 0.5 e^-4.5 > 1/255; four away it is not
    assert float(sem[0, 4, 6]) > 0 and float(sem[0, 4, 7]) == 0


def test_thresholds_and_stop_match_the_sequential_loop():
    gs = [(3.0, 4.0, 0.5, 1.0, [1.0, 0.0]),
          (3.0, 4.0, 0.6, 2.0, [0.0, 1.0]),
          (3.5, 4.0, 0.995, 3.0, [1.0, 1.0]),   # clamped to 0.99
          (3.0, 4.5, 0.99, 4.0, [2.0, 0.0]),
          (3.0, 4.0, 0.9, 5.0, [0.0, 3.0]),
          (3.0, 4.0, 0.99, 5.5, [4.0, 0.0]),    # T falls under 1e-4 here
          (3.0, 4.0, 0.9, 6.0, [0.0, 7.0]),     # never reached at (3, 4)
          (9.0, 9.0, 0.01, 0.5, [5.0, 5.0])]    # alpha under 1/255 off centre
    sp = splats(gs)
    lists = raster.tile_lists(sp)
    want, pairs, stops = sequential(sp)
    assert stops > 0
    got = raster.render(sp, lists, color=False)
    assert np.allclose(got["semantics"].numpy(), want, atol=1e-6)
    assert raster.blended_pairs(sp, lists) == (pairs, len(gs))


def test_semantic_grad_is_the_weights():
    sp = splats([(3.0, 4.0, 0.5, 1.0, [1.0, 0.0]),
                 (3.0, 4.0, 0.6, 2.0, [0.0, 1.0])])
    lists = raster.tile_lists(sp)
    g = torch.zeros((2, 16, 16))
    g[0, 4, 3] = 1.0
    g[1, 4, 4] = 2.0
    grad = raster.semantic_grad(sp, lists, g)
    a0 = 0.5 * math.exp(-0.5)
    a1 = 0.6 * math.exp(-0.5)
    want = torch.tensor([[0.5, 2 * a0], [0.3, 2 * a1 * (1 - a0)]])
    assert torch.allclose(grad, want, atol=1e-6)


def test_loss_by_hand():
    weight = torch.tensor([[1.0, 0.0], [0.0, 1.0]])
    bias = torch.tensor([0.0, 0.5])
    lut = torch.tensor([[1.0, 0.0], [0.0, 2.0]])
    sem = torch.tensor([[2.0, 0.0], [0.0, 1.0]])
    gt = torch.tensor([[3.0, 4.0], [0.0, -1.0]])
    got = float(semantic.distill_loss(weight, bias, lut, sem, gt))
    # by hand: logits (2, 0.5) and (0, 1.5)
    p0 = np.exp([2.0, 0.5]) / np.exp([2.0, 0.5]).sum()
    p1 = np.exp([0.0, 1.5]) / np.exp([0.0, 1.5]).sum()
    gtl = np.array([[0.6, 0.8], [0.0, -1.0]])
    sim = gtl @ np.eye(2)                       # unit LUT rows are e0, e1
    label = np.array([[0, 1], [1, 0]])          # argmax of each row
    lab = 50 * np.mean((np.stack([p0, p1]) - label) ** 2)
    sl = 1 - np.mean([0.8, 0.0])
    # picks: code 0 (row (1, 0)) and code 1 (row (0, 2))
    recc = 1 - np.mean([0.6, -1.0])
    ent = [-(np.exp(r) / np.exp(r).sum() * (r - np.log(np.exp(r).sum()))
             ).sum() for r in sim]
    want = lab + sl + 0.3 * np.mean(ent) + recc
    assert math.isclose(got, want, rel_tol=1e-6)


def test_adam_by_hand():
    opt = semantic.Adam(0.1, 1e-8)
    p = opt.step(torch.tensor([1.0]), torch.tensor([0.5]))
    assert math.isclose(float(p), 0.9, rel_tol=1e-6)
    p = opt.step(p, torch.tensor([0.5]))
    assert math.isclose(float(p), 0.8, rel_tol=1e-6)


def test_kmeans_draws_a_permutation_every_iteration():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(50, 4, generator=torch.Generator().manual_seed(1))
    semantic.kmeans(gen, x, 5, niter=3)
    ref = torch.Generator().manual_seed(0)
    for _ in range(4):
        torch.randperm(50, generator=ref)
    assert torch.equal(torch.randperm(50, generator=gen),
                       torch.randperm(50, generator=ref))
