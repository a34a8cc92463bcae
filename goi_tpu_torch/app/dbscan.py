"""DBSCAN with scikit-learn's labels, on the points' device.

`QuerySession.group_points` splits a retrieved set into instances with
DBSCAN (ref:gui/main.py:1595-1671, `sklearn.cluster.DBSCAN`). Both
functions here give sklearn's `fit_predict` labels exactly, not up to a
permutation:

- the eps-neighbourhood of a point counts the point itself and every
  point at distance <= eps, the squared distance taken in float64 as
  sklearn's kd-tree takes it, ((dx*dx + dy*dy) + dz*dz) <= eps*eps;
- a point is core when its neighbourhood holds >= min_samples points;
- clusters are the connected components of the core points, numbered
  in the order of their lowest-index core point (sklearn expands one
  cluster fully, in index order, before it starts the next);
- a non-core point with core neighbours takes the lowest-numbered
  cluster among theirs; every other point is noise, -1.

`dbscan` is the path: torch on the points' device, with no (n, n)
tensor and no neighbour list. The points are sorted by a grid of cell
side eps / sqrt(d), so that all points of one cell are within eps of
each other and a point's neighbours lie in the (2 r + 1)^d cells around
its own (r = 2 for d = 3). The candidate pairs of those cell ranges are
expanded in chunks of at most `PAIR_BUDGET` pairs and tested, three
times: the neighbour counts (core flags); for core points, which pairs
of cells hold a core pair within eps (the core points of one cell are
connected), whose components come from min-label propagation with
pointer jumping on the cell graph; and for non-core points, the least
cluster among their core neighbours.

`dbscan_plain` is its plain twin for tests and checks: scipy's cKDTree
for the candidate pairs, the same float64 test, and scipy's connected
components.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

# the cell side is eps / sqrt(d) shrunk by this factor, so that two
# points of one cell are within eps with room for rounding
_SHRINK = 1.0 - 1e-6
# candidate pairs a chunk expands at most (~100 bytes each on the way)
PAIR_BUDGET = 1 << 25


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared distances of the rows of a and b, float64, summed in
    coordinate order as sklearn's kd-tree sums them."""
    d = a[:, 0] - b[:, 0]
    acc = d * d
    for k in range(1, a.shape[1]):
        d = a[:, k] - b[:, k]
        acc = acc + d * d
    return acc


class _Grid:
    """Points sorted by cell; each cell's neighbour-cell ranges."""

    def __init__(self, p: torch.Tensor, eps: float):
        n, dim = p.shape
        side = eps / math.sqrt(dim) * _SHRINK
        reach = int(math.floor(eps / side * (1.0 + 1e-6))) + 1
        # shifted by `reach`, so a neighbour offset never leaves the grid
        cell = torch.floor((p - p.min(0).values) / side).long() + reach
        dims = (cell.max(0).values + reach + 1).tolist()
        if math.prod(dims) >= 1 << 62:
            raise ValueError(f"dbscan: eps={eps} is too small for the "
                             f"points' extent ({dims} cells)")
        stride = [math.prod(dims[:k]) for k in range(dim)]
        key = sum(cell[:, k] * stride[k] for k in range(dim))
        key, self.order = torch.sort(key, stable=True)
        self.p = p[self.order]
        cells, self.cid, counts = torch.unique_consecutive(
            key, return_inverse=True, return_counts=True)
        starts = torch.cumsum(counts, 0) - counts
        offsets = itertools.product(range(-reach, reach + 1), repeat=dim)
        delta = torch.tensor([sum(o[k] * stride[k] for k in range(dim))
                              for o in offsets], device=p.device)
        want = cells[:, None] + delta[None, :]              # (cells, O)
        nb = torch.clamp(torch.searchsorted(cells, want), max=len(cells) - 1)
        hit = cells[nb] == want
        self.n_cells = len(cells)
        self.delta = delta
        self.nb_start = torch.where(hit, starts[nb], 0)
        self.nb_len = torch.where(hit, counts[nb], 0)

    def pairs(self, queries: torch.Tensor, cols: torch.Tensor, eps2: float,
              budget: int):
        """Yield (q, j), sorted-order indices of the pairs within eps of
        each query q in `queries` and a point j of its neighbour cells
        `cols` (indices into the offsets), in chunks of queries whose
        candidate pairs number at most `budget` (or one query)."""
        if len(queries) == 0:
            return
        qcell = self.cid[queries]
        lens = self.nb_len[:, cols]
        starts = self.nb_start[:, cols]
        total = torch.cumsum(lens[qcell].sum(1), 0).cpu().numpy()
        lo = 0
        while lo < len(queries):
            base = total[lo - 1] if lo else 0
            hi = int(np.searchsorted(total, base + budget, side="right"))
            hi = max(hi, lo + 1)
            n_pairs = int(total[hi - 1] - base)
            if n_pairs:
                qc = qcell[lo:hi]
                seg_len = lens[qc].reshape(-1)
                seg_start = starts[qc].reshape(-1)
                seg = torch.repeat_interleave(
                    torch.arange(len(seg_len), device=seg_len.device),
                    seg_len, output_size=n_pairs)
                first = torch.cumsum(seg_len, 0) - seg_len
                j = seg_start[seg] + (torch.arange(n_pairs,
                                                   device=seg.device)
                                      - first[seg])
                q = queries[lo:hi][seg // len(cols)]
                near = _sq_dist(self.p[q], self.p[j]) <= eps2
                yield q[near], j[near]
            lo = hi


def _components(n: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Component representative of each of n nodes joined by the edges
    (a, b): min-label propagation with pointer jumping to a fixpoint."""
    lab = torch.arange(n, device=a.device)
    while True:
        m = torch.minimum(lab[a], lab[b])
        new = lab.scatter_reduce(0, a, m, "amin").scatter_reduce(
            0, b, m, "amin")
        while True:
            jumped = new[new]
            if torch.equal(jumped, new):
                break
            new = jumped
        if torch.equal(new, lab):
            return lab
        lab = new


@torch.no_grad()
def dbscan(points: torch.Tensor, eps: float,
           min_samples: int) -> torch.Tensor:
    """sklearn.cluster.DBSCAN(eps, min_samples).fit_predict(points) as an
    int64 tensor on the points' device (see the module docstring)."""
    n = points.shape[0]
    dev = points.device
    if n == 0:
        return torch.zeros(0, dtype=torch.int64, device=dev)
    eps = float(eps)
    eps2 = eps * eps
    g = _Grid(points.detach().to(torch.float64), eps)
    every = torch.arange(len(g.delta), device=dev)
    allq = torch.arange(n, device=dev)

    count = torch.zeros(n, dtype=torch.int64, device=dev)
    for q, _ in g.pairs(allq, every, eps2, PAIR_BUDGET):
        count += torch.bincount(q, minlength=n)
    core = count >= min_samples

    # cell graph of the core points: the core points of a cell are
    # within eps of each other; two cells are joined by a core pair
    # within eps (each unordered pair of cells seen once, from the cell
    # of the lower key)
    core_q = torch.nonzero(core).squeeze(1)
    ahead = torch.nonzero(g.delta > 0).squeeze(1)
    edges = [torch.zeros(0, dtype=torch.int64, device=dev)]
    for q, j in g.pairs(core_q, ahead, eps2, PAIR_BUDGET):
        keep = core[j]
        edges.append(torch.unique(g.cid[q[keep]] * g.n_cells
                                  + g.cid[j[keep]]))
    edges = torch.unique(torch.cat(edges))
    comp = _components(g.n_cells, edges // g.n_cells, edges % g.n_cells)

    # clusters numbered by their lowest original index of a core point
    first = torch.full((g.n_cells,), n, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, comp[g.cid[core_q]], g.order[core_q], "amin")
    present = torch.nonzero(first < n).squeeze(1)
    number = torch.full((g.n_cells,), -1, dtype=torch.int64, device=dev)
    number[present[torch.argsort(first[present])]] = torch.arange(
        len(present), device=dev)
    label = torch.full((n,), -1, dtype=torch.int64, device=dev)
    label[core_q] = number[comp[g.cid[core_q]]]

    border = torch.full((n,), n, dtype=torch.int64, device=dev)
    for q, j in g.pairs(torch.nonzero(~core).squeeze(1), every, eps2,
                        PAIR_BUDGET):
        keep = core[j]
        border.scatter_reduce_(0, q[keep], label[j[keep]], "amin")
    label = torch.where(~core & (border < n), border, label)

    out = torch.empty_like(label)
    out[g.order] = label
    return out


def dbscan_plain(points, eps: float, min_samples: int) -> torch.Tensor:
    """The plain twin of `dbscan`: candidate pairs from scipy's cKDTree,
    the same float64 test, scipy's connected components. Returns int64
    labels on the points' device."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    from scipy.spatial import cKDTree

    dev = points.device if torch.is_tensor(points) else torch.device("cpu")
    p = (points.detach().cpu().numpy() if torch.is_tensor(points)
         else np.asarray(points)).astype(np.float64)
    n = len(p)
    eps = float(eps)
    eps2 = eps * eps
    # a candidate radius a hair wider than eps; the exact test follows
    pairs = cKDTree(p).query_pairs(eps * (1.0 + 1e-6),
                                   output_type="ndarray")
    i, j = pairs[:, 0].astype(np.int64), pairs[:, 1].astype(np.int64)
    d2 = (p[i, 0] - p[j, 0]) ** 2
    for k in range(1, p.shape[1]):
        d2 = d2 + (p[i, k] - p[j, k]) ** 2
    near = d2 <= eps2
    i, j = i[near], j[near]
    count = 1 + np.bincount(i, minlength=n) + np.bincount(j, minlength=n)
    core = count >= min_samples
    labels = np.full(n, -1, np.int64)
    cc = core[i] & core[j]
    graph = coo_matrix((np.ones(int(cc.sum())), (i[cc], j[cc])),
                       shape=(n, n))
    _, comp = connected_components(graph, directed=False)
    core_idx = np.nonzero(core)[0]
    comps, first = np.unique(comp[core_idx], return_index=True)
    number = np.full(comp.max() + 1 if n else 0, -1, np.int64)
    number[comps[np.argsort(first)]] = np.arange(len(comps))
    labels[core_idx] = number[comp[core_idx]]
    best = np.full(n, n, np.int64)
    for a, b in ((i, j), (j, i)):
        m = ~core[a] & core[b]
        np.minimum.at(best, a[m], labels[b[m]])
    labels = np.where(~core & (best < n), best, labels)
    return torch.as_tensor(labels, device=dev)
