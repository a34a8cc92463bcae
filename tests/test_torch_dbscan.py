"""goi_tpu_torch.app.dbscan: `dbscan` (torch, here on CPU tensors) and
its plain twin `dbscan_plain` (scipy) give sklearn.cluster.DBSCAN's
fit_predict labels exactly, numbering included: blobs with noise, a
border point between two clusters, points at exactly eps,
min_samples=1, chunked candidate pairs and empty input."""

import numpy as np
import pytest
import torch
from sklearn.cluster import DBSCAN

from goi_tpu_torch.app import dbscan as dbscan_mod
from goi_tpu_torch.app.dbscan import dbscan, dbscan_plain

torch.set_num_threads(1)


def _labels(points, eps, min_samples):
    """(sklearn's, dbscan's, dbscan_plain's) labels as numpy."""
    ref = DBSCAN(eps=eps, min_samples=min_samples).fit_predict(points)
    pts = torch.as_tensor(points)
    got = dbscan(pts, eps, min_samples)
    plain = dbscan_plain(pts, eps, min_samples)
    assert got.dtype == plain.dtype == torch.int64
    return ref, got.numpy(), plain.numpy()


def _same(points, eps, min_samples):
    ref, got, plain = _labels(points, eps, min_samples)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(plain, ref)
    return ref


def _blobs(seed, n_blobs=6, per=250, noise=200, dim=3):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-3, 3, (n_blobs, dim))
    pts = np.concatenate(
        [c + rng.normal(0, 0.4, (per, dim)) for c in centers]
        + [rng.uniform(-4, 4, (noise, dim))]).astype(np.float32)
    return pts[rng.permutation(len(pts))]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("eps,min_samples", [(0.3, 8), (0.5, 20)])
def test_blobs_with_noise_match_sklearn(seed, eps, min_samples):
    ref = _same(_blobs(seed), eps, min_samples)
    assert ref.max() >= 2 and (ref == -1).any()


def test_candidate_pairs_in_small_chunks(monkeypatch):
    """The same labels when the pairs run in chunks of at most 700 (one
    query alone when its candidates alone exceed that)."""
    monkeypatch.setattr(dbscan_mod, "PAIR_BUDGET", 700)
    _same(_blobs(3), 0.4, 12)


def test_border_point_takes_the_lowest_numbered_cluster():
    """Two chains of core points along x with one border point between
    them, within eps of a core point of each; the right chain holds the
    lowest index, so it is cluster 0 and the border point joins it."""
    left = np.stack([np.arange(10) * 0.1, np.zeros(10), np.zeros(10)], 1)
    right = left + [2.1, 0.0, 0.0]
    border = np.array([[1.5, 0.0, 0.0]])
    pts = np.concatenate([right[:1], left, border, right[1:]]
                         ).astype(np.float32)
    ref = _same(pts, 0.65, 4)
    assert ref[0] == 0 and ref[1] == 1            # right, then left
    assert ref[11] == 0                            # the border point
    # its own count (itself and one point of each chain) is under 4
    d = np.linalg.norm(pts - pts[11], axis=1)
    assert (d <= 0.65).sum() == 3
    # numbered the other way round, it joins the left chain
    swapped = np.concatenate([left, border, right]).astype(np.float32)
    ref = _same(swapped, 0.65, 4)
    assert ref[0] == 0 and ref[10] == 0 and ref[11] == 1


@pytest.mark.parametrize("min_samples", [5, 6, 7])
def test_points_at_exactly_eps_are_neighbours(min_samples):
    """A 6^3 integer grid at eps = 1: each face neighbour lies at
    exactly eps, and sklearn counts it; so do both versions."""
    g = np.stack(np.meshgrid(*[np.arange(6)] * 3, indexing="ij"), -1)
    g = g.reshape(-1, 3).astype(np.float32)
    ref = _same(g, 1.0, min_samples)
    counts = (np.linalg.norm(g[:, None] - g[None], axis=-1) <= 1.0).sum(1)
    # interior points count 7: themselves and 6 at distance eps, which
    # make them core
    assert counts.max() == 7 and (ref != -1).any()
    # a hair under eps, no grid point has a neighbour: all noise
    ref, got, plain = _labels(g, 1.0 - 1e-7, 2)
    assert (ref == -1).all() and (got == -1).all() and (plain == -1).all()


def test_min_samples_one_makes_every_point_core():
    pts = _blobs(4, n_blobs=3, per=100, noise=50)
    ref = _same(pts, 0.2, 1)
    assert (ref >= 0).all()


def test_two_dims_and_edge_cases():
    rng = np.random.default_rng(5)
    _same(rng.normal(0, 1, (600, 2)).astype(np.float32), 0.15, 5)
    empty = torch.zeros((0, 3))
    assert dbscan(empty, 0.3, 5).shape == (0,)
    # a single cluster of identical points
    same = np.zeros((20, 3), np.float32)
    assert (_same(same, 0.1, 5) == 0).all()
